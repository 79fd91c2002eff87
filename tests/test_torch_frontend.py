"""The port's fused FOA front-end (seld_tpu_torch/ops/frontend.py) against
the JAX package's Pallas front-end (run in interpret mode, as
tests/test_pallas.py runs it) and its `extract_features(mode="foa",
method="fft")`.

Tolerance 1e-4 absolute on the dB and IV channels, f32: on these clips
the two JAX front-ends themselves differ by up to 1.2e-5 dB and 6.1e-5 IV
(the IV normalisation amplifies rounding where the three products nearly
cancel); the port's plain version sums the 1024-term DFT in another order
again. Clips are full-scale or quiet uniform noise, quantised to int16.
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
    """The bases and filterbank are JAX's values; the kernel's packing puts
    each 32-bin chunk's cos columns then its sin columns, zero past the
    last bin."""
    wre, wim, fb = F._frontend_constants(1024, 960, 64, SR)
    jre, jim, jfb = JF._frontend_constants(1024, 960, 64, SR)
    np.testing.assert_array_equal(wre, jre[:, :513])
    np.testing.assert_array_equal(wim, jim[:, :513])
    np.testing.assert_array_equal(fb, jfb[:513])
    wcat, fbank, chunks = F._kernel_constants(1024, 960, 64, SR,
                                              torch.device("cpu"))
    assert chunks == 17 and wcat.shape == (1024, 17 * 64)
    w = wcat.numpy().reshape(1024, 17, 2, 32)
    np.testing.assert_array_equal(w[:, :, 0].reshape(1024, -1)[:, :513], wre)
    np.testing.assert_array_equal(w[:, :, 1].reshape(1024, -1)[:, :513], wim)
    assert not w[:, -1, :, 1:].any()
    np.testing.assert_array_equal(fbank.numpy()[:513], fb)
    assert not fbank.numpy()[513:].any()


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
