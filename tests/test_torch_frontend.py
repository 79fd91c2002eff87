"""The port's fused FOA front-end (seld_tpu_torch/ops/frontend.py) against
the JAX package's Pallas front-end (run in interpret mode, as
tests/test_pallas.py runs it) and its `extract_features(mode="foa",
method="fft")`.

Tolerance 1e-4 absolute on the dB and IV channels, f32: on these clips
the two JAX front-ends themselves differ by up to 1.2e-5 dB and 6.1e-5 IV
(the IV normalisation amplifies rounding where the three products nearly
cancel); the port's plain version sums the 1024-term DFT in another order
again. Clips are full-scale or quiet uniform noise, quantised to int16.
The CUDA kernel's tables (window, twiddles, the filterbank's sparse rows)
are held to their float64 definitions and to the filterbank, and a CPU
model of the kernel's decomposition to the plain version, at the same
tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.ops import extract_features as jax_extract_features
from seld_tpu.ops.pallas import frontend as JF
from seld_tpu_torch.ops import frontend as F

torch.set_num_threads(1)
ATOL = 1e-4
SR = 24000


def _clip(seed, seconds, amplitude):
    """4-channel uniform noise of peak `amplitude`, quantised to int16 and
    scaled back, as the wav pipeline feeds the front-end."""
    rng = np.random.RandomState(seed)
    wav = rng.uniform(-1, 1, (4, int(SR * seconds))) * amplitude
    pcm = np.round(wav * 32767).astype(np.int16)
    return pcm.astype(np.float32) / 32768.0


@pytest.mark.parametrize("seed,seconds,amplitude", [(0, 1.0, 1.0),
                                                    (1, 0.5, 0.05)])
@pytest.mark.parametrize("layout", ["frames", "2d"])
def test_fused_frontend_matches_jax(seed, seconds, amplitude, layout):
    wav = _clip(seed, seconds, amplitude)
    jax_fn = JF.fused_foa_frontend if layout == "frames" \
        else JF.fused_foa_frontend_2d
    port_fn = F.fused_foa_frontend if layout == "frames" \
        else F.fused_foa_frontend_2d
    got = port_fn(torch.from_numpy(wav)).numpy()
    want = np.asarray(jax_fn(jnp.asarray(wav), interpret=True))
    ref = np.asarray(jax_extract_features(jnp.asarray(wav), mode="foa",
                                          method="fft"))
    # 0.5 s: 26 frames, a ragged last tile
    assert got.shape == want.shape == ref.shape == (
        1 + wav.shape[1] // 480, 64, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_kernel_constants_hold_jax_values():
    """The bases and filterbank are JAX's values; the kernel's tables hold
    JAX's window and, as sparse rows, JAX's filterbank."""
    wre, wim, fb = F._frontend_constants(1024, 960, 64, SR)
    jre, jim, jfb = JF._frontend_constants(1024, 960, 64, SR)
    np.testing.assert_array_equal(wre, jre[:, :513])
    np.testing.assert_array_equal(wim, jim[:, :513])
    np.testing.assert_array_equal(fb, jfb[:513])
    tables = F._kernel_constants(1024, 960, 64, SR, torch.device("cpu"))
    window, tw, idx, weights = (a.numpy() for a in tables)
    assert window.dtype == tw.dtype == weights.dtype == np.float32
    assert idx.dtype == np.int32 and tw.shape == (F._TWIDDLES, 2)
    # JAX folds the window into its bases: column 0 of the cos basis
    np.testing.assert_array_equal(window, jre[:, 0])
    np.testing.assert_array_equal(_dense(idx, weights, 513), jfb[:513])


def _dense(idx, weights, n_bins, n_mels=64):
    """The kernel's sparse rows (first bins, row pointers, weights) as a
    dense [n_bins, n_mels] filterbank."""
    starts, ptr = idx[:n_mels], idx[n_mels:]
    fb = np.zeros((n_bins, n_mels), np.float32)
    for m in range(n_mels):
        run = weights[ptr[m]:ptr[m + 1]]
        fb[starts[m]:starts[m] + run.size, m] = run
    return fb


@pytest.mark.parametrize("sample_rate", [24000, 16000, 48000])
def test_sparse_rows_rebuild_the_filterbank_exactly(sample_rate):
    """One contiguous run of bins a mel, at most 2 mels a bin (so at most
    2 x 513 weights, what the kernel's shared memory holds)."""
    fb = F._frontend_constants(1024, 960, 64, sample_rate)[2]
    t = F._kernel_tables(1024, 960, 64, sample_rate)
    assert t.fb_index.shape == (129,) and t.fb_index[64] == 0
    assert t.fb_index[-1] == t.fb_weights.size == np.count_nonzero(fb)
    assert (np.count_nonzero(fb, axis=1) <= 2).all()
    assert t.fb_weights.size <= F._MAX_NNZ
    np.testing.assert_array_equal(_dense(t.fb_index, t.fb_weights, 513), fb)
    if sample_rate == SR:
        assert t.fb_weights.size == 999


def _within_one_ulp(got, want64):
    ulp = np.spacing(np.abs(want64).astype(np.float32))
    assert (np.abs(got.astype(np.float64) - want64) <= ulp).all()


def test_twiddles_and_window_within_one_ulp_of_float64():
    t = F._kernel_tables(1024, 960, 64, SR)
    n = np.arange(960)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / 960)
    _within_one_ulp(t.window, np.pad(hann, (32, 32)))
    j, k1 = np.divmod(np.arange(512), 8)
    b, c = np.divmod(np.arange(64), 8)
    for got, m, size in ((t.twiddles[:F._TW2], j * k1, 512),
                         (t.twiddles[F._TW2:F._TW3], b * c, 64),
                         (t.twiddles[F._TW3:], np.arange(256), 1024)):
        want = np.exp(-2j * np.pi * m / size)
        _within_one_ulp(got[:, 0], want.real)
        _within_one_ulp(got[:, 1], want.imag)


def _kernel_model(padded, hop=480, eps=1e-8):
    """Plain-torch model of csrc/foa_frontend.cu's decomposition, from its
    tables, vectorised over frames: z[n] = x[2n] + i x[2n+1] windowed, the
    512-point FFT as three radix-8 passes (pass 1 over n1 of n = 64 n1 + j
    times W_512^(j k1); pass 2 over a of n2 = 8 a + b times W_64^(b c);
    pass 3 over b, giving Z[k1 + 8 c + 64 e]), the split step for bins k
    and 512 - k (k < 256) and 256, the power and IV, and each mel's run of
    bins. Tests only."""
    t = F._kernel_tables(1024, 960, 64, SR)
    tw = torch.complex(*torch.from_numpy(t.twiddles).T.contiguous())
    frames = padded.unfold(-1, 1024, hop) * torch.from_numpy(t.window)
    z = torch.complex(frames[..., 0::2], frames[..., 1::2])
    lead = z.shape[:-1]
    r8 = np.arange(8)
    w8 = torch.from_numpy(np.exp(-2j * np.pi * np.outer(r8, r8) / 8)
                          .astype(np.complex64))
    y = torch.einsum("kn,...nj->...kj", w8, z.reshape(*lead, 8, 64))
    y = y * tw[:F._TW2].reshape(64, 8).T                  # [k1, j]
    y = y.reshape(*lead, 8, 8, 8)                          # [k1, a, b]
    u = torch.einsum("ca,...kab->...kcb", w8, y)
    u = u * tw[F._TW2:F._TW3].reshape(8, 8).T             # [k1, c, b]
    e = torch.einsum("eb,...kcb->...kce", w8, u)           # [k1, c, e]
    zf = e.permute(*range(len(lead)), -1, -2, -3).reshape(*lead, 512)
    k = torch.arange(256)
    zk, zm = zf[..., :256], zf[..., (512 - k) % 512]
    even = (zk + zm.conj()) / 2
    odd = -0.5j * (zk - zm.conj()) * tw[F._TW3:]
    x = zf.new_zeros(lead + (513,))
    x[..., :256] = even + odd
    x[..., 512 - k] = (even - odd).conj()      # k = 0 gives bin 512
    x[..., 256] = zf[..., 256].conj()
    power = x.real ** 2 + x.imag ** 2                     # [n, 4, T, 513]
    w, xyz = x[:, :1], x[:, [3, 1, 2]]
    ivc = w.real * xyz.real + w.imag * xyz.imag
    iv = ivc / torch.clamp_min(torch.sqrt((ivc ** 2).sum(1, keepdim=True)),
                               eps)
    starts, ptr = t.fb_index[:64], t.fb_index[64:]
    weights = torch.from_numpy(t.fb_weights)

    def project(v):
        return torch.stack([
            v[..., starts[m]:starts[m] + ptr[m + 1] - ptr[m]]
            @ weights[ptr[m]:ptr[m + 1]] for m in range(64)], -1)
    return project(power), project(iv)


@pytest.mark.parametrize("seed,seconds,amplitude,silent", [
    (4, 0.5, 1.0, False), (5, 0.4, 0.01, False), (6, 0.5, 0.3, True)])
def test_kernel_decomposition_matches_the_plain_version(seed, seconds,
                                                        amplitude, silent):
    """The kernel's algorithm, modelled on the CPU from its own tables,
    holds `foa_frontend_ref` to 1e-4 on dB and IV; all-silent frames give
    exactly 0."""
    wav = np.stack([_clip(seed, seconds, amplitude),
                    _clip(seed + 10, seconds, amplitude / 3)])
    if silent:
        wav[1, :, wav.shape[-1] // 2:] = 0
    padded = F.reflect_pad(torch.from_numpy(wav), 512).contiguous()
    mel, iv = _kernel_model(padded)
    mel_r, iv_r = F.foa_frontend_ref(padded)
    assert mel.shape == mel_r.shape and iv.shape == iv_r.shape
    db = F.amplitude_to_db(mel, clip_dims=1)
    db_r = F.amplitude_to_db(mel_r, clip_dims=1)
    np.testing.assert_allclose(db.numpy(), db_r.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(iv.numpy(), iv_r.numpy(), rtol=0, atol=ATOL)
    if silent:
        quiet = slice(1 + (wav.shape[-1] // 2 + 512) // 480, None)
        assert (mel[1, :, quiet] == 0).all() and (iv[1, :, quiet] == 0).all()


def test_db_floor_is_per_clip():
    """A chunk of one loud and one quiet clip equals the clips one at a
    time: one max over the chunk would floor the quiet clip at the loud
    clip's level."""
    loud, quiet = _clip(1, 0.5, 1.0), _clip(2, 0.5, 0.001)
    both = F.fused_foa_frontend(torch.from_numpy(np.stack([loud, quiet])))
    for i, clip in enumerate((loud, quiet)):
        alone = F.fused_foa_frontend(torch.from_numpy(clip))
        np.testing.assert_array_equal(both[i].numpy(), alone.numpy())
    # the quiet clip's floor lies far below the loud one's
    assert both[1, ..., :4].min() < both[0, ..., :4].min() - 40


def test_silence_gives_zero_iv_and_the_amin_floor():
    wav = np.zeros((4, 12000), np.float32)
    wav[:, 6000:] = _clip(3, 0.25, 0.5)    # silent first half
    mel, iv = F.foa_frontend(F.reflect_pad(torch.from_numpy(wav)[None], 512))
    silent = slice(0, 10)                  # frames that see only zeros
    assert (iv[0, :, silent] == 0).all()
    assert (mel[0, :, silent] == 0).all()
    feats = F.fused_foa_frontend(torch.zeros(4, 4800))
    assert (feats[..., 4:] == 0).all()
    assert torch.allclose(feats[..., :4], torch.tensor(-100.0))


@pytest.mark.parametrize("fn", [F.fused_foa_frontend, F.fused_foa_frontend_2d])
def test_wrong_channel_count_raises(fn):
    with pytest.raises(ValueError, match="4 input channels"):
        fn(torch.zeros(2, 4800))
    with pytest.raises(ValueError, match=r"\[n, 4, samples\]"):
        F.foa_frontend(torch.zeros(1, 3, 4800))
