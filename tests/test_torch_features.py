"""The port's feature front-end pieces (seld_tpu_torch/ops/{stft,mel,
features}.py) against the JAX package's (seld_tpu/ops/{stft,mel,
features}.py) on the same numpy inputs: FOA (log-mel + IV), microphone-
array (log-mel + GCC-PHAT, on noise at a realistic level and on a stretch
of exact digital silence) and SALSA-lite.

Tolerances: the filterbank and the labels are built by the same numpy code
and must be equal; the spectra to 1e-4 of their largest magnitude (f32
FFTs in another order); the features to 1e-4 absolute (dB, IV and GCC,
as tests/test_torch_frontend.py states); SALSA-lite to 1e-4 of its largest
magnitude; the preprocessing, statistics and normalizer to f32 rounding.
"""
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.ops import features as JFe
from seld_tpu.ops import mel as JM
from seld_tpu_torch.ops import features as Fe
from seld_tpu_torch.ops import mel as M
from seld_tpu_torch.ops import stft as S

# seld_tpu.ops exports the function `stft` under the module's name
JS = importlib.import_module("seld_tpu.ops.stft")
torch.set_num_threads(1)
ATOL = 1e-4
SR = 24000


def _pcm(seed, n, amplitude=0.5, dtype=np.int16):
    rng = np.random.RandomState(seed)
    bits = np.iinfo(dtype).max
    return np.round(rng.uniform(-1, 1, (4, n)) * amplitude * bits
                    ).astype(dtype)


@pytest.mark.parametrize("method", ["fft", "matmul"])
def test_complex_spec_matches_jax(method):
    wav = np.random.RandomState(0).randn(4, 4800).astype(np.float32)
    got = S.complex_spec(torch.from_numpy(wav), n_fft=1024, win_length=960,
                         hop_length=480, method=method).numpy()
    want = np.asarray(JS.complex_spec(jnp.asarray(wav), n_fft=1024,
                                      win_length=960, hop_length=480,
                                      method=method))
    assert got.shape == want.shape == (4, 513, 11)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_window_and_bases_equal_jax():
    np.testing.assert_array_equal(S._padded_window(1024, 960).numpy(),
                                  np.asarray(JS._padded_window(1024, 960)))
    np.testing.assert_array_equal(S.hann_window(64).numpy(),
                                  np.asarray(JS.hann_window(64)))
    for got, want in zip(S._dft_bases(1024), JS._dft_bases(1024)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_freqs,n_mels,sr", [(513, 64, 24000),
                                               (257, 40, 16000)])
def test_mel_filterbank_equal(n_freqs, n_mels, sr):
    got = M.mel_filterbank(n_freqs, n_mels, sr).numpy()
    want = np.asarray(JM.mel_filterbank(n_freqs, n_mels, sr))
    np.testing.assert_array_equal(got, want)


def test_amplitude_to_db_matches_jax():
    x = (np.random.RandomState(1).rand(4, 64, 30) ** 8).astype(np.float32)
    x[0, :3] = 0.0
    got = M.amplitude_to_db(torch.from_numpy(x)).numpy()
    want = np.asarray(JM.amplitude_to_db(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # per clip over a batch: each slice gets its own floor
    batch = M.amplitude_to_db(torch.from_numpy(np.stack([x, x * 1e-6])),
                              clip_dims=1)
    np.testing.assert_allclose(batch[0].numpy(), want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        batch[1].numpy(), np.asarray(JM.amplitude_to_db(jnp.asarray(
            x * 1e-6))), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32])
def test_extract_features_matches_jax(dtype):
    pcm = _pcm(2, 12000, dtype=np.int16 if dtype == np.float32 else dtype)
    wav = pcm.astype(np.float32) / 32768.0 if dtype == np.float32 else pcm
    got = Fe.extract_features(torch.from_numpy(wav)).numpy()
    want = np.asarray(JFe.extract_features(jnp.asarray(wav), mode="foa",
                                           method="fft"))
    assert got.shape == want.shape == (26, 64, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_extract_features_batch_and_clips_match_jax():
    clips = [_pcm(3, 12000), _pcm(4, 12000, amplitude=0.01),
             _pcm(5, 9600, dtype=np.int32), _pcm(6, 12000)]
    batch = np.stack([clips[0], clips[1]])
    got = Fe.extract_features_batch(torch.from_numpy(batch)).numpy()
    want = np.asarray(JFe.extract_features_batch(jnp.asarray(batch),
                                                 method="fft"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    got = Fe.extract_features_clips(clips, chunk_size=2, device="cpu")
    want = JFe.extract_features_clips(clips, chunk_size=2, method="fft")
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_mels,n_fft,win_length,hop_length", [
    (40, 1024, 960, 480), (64, 512, 480, 240), (40, 512, 512, 256)])
def test_extract_features_batch_at_other_shapes_matches_jax(
        n_mels, n_fft, win_length, hop_length):
    """Shapes the front-end kernel does not take run the plain
    composition (on the card too); here against the JAX package's."""
    batch = np.stack([_pcm(7, 12000), _pcm(8, 12000, amplitude=0.05)])
    kw = dict(n_mels=n_mels, n_fft=n_fft, win_length=win_length,
              hop_length=hop_length)
    got = Fe.extract_features_batch(torch.from_numpy(batch), **kw).numpy()
    want = np.asarray(JFe.extract_features_batch(jnp.asarray(batch),
                                                 method="fft", **kw))
    assert got.shape == want.shape == (2, 12000 // hop_length + 1, n_mels, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_mels,n_fft,win_length,takes", [
    (64, 1024, 960, True), (64, 1024, 1024, True), (64, 1024, 1, True),
    (40, 1024, 960, False), (128, 1024, 960, False), (64, 512, 480, False),
    (64, 2048, 960, False), (64, 1024, 0, False), (64, 1024, 1025, False)])
def test_frontend_route_rule(n_mels, n_fft, win_length, takes):
    """The kernel gets exactly the shapes csrc/foa_frontend.cu takes; its
    wrapper keeps raising on any other."""
    from seld_tpu_torch.ops import frontend
    assert frontend.frontend_applicable(n_mels, n_fft, win_length) == takes
    if not takes:
        wav = torch.zeros(1, 4, n_fft + 960)
        with pytest.raises(ValueError, match="front-end kernel takes"):
            frontend._foa_frontend_cuda(wav, n_fft, win_length, 480, n_mels,
                                        24000, 1e-8)


def _mic_clip(seed, n=12000, silent=None):
    """Noise at a realistic level (a few hundredths of full scale), int16
    PCM, with an optional stretch of exact digital silence."""
    pcm = _pcm(seed, n, amplitude=0.05)
    if silent is not None:
        pcm[:, silent[0]:silent[1]] = 0
    return pcm


def _spec(wav):
    w = wav.astype(np.float32) / 32768.0
    got = S.complex_spec(torch.from_numpy(w), n_fft=1024, win_length=960,
                         hop_length=480)
    want = JS.complex_spec(jnp.asarray(w), n_fft=1024, win_length=960,
                           hop_length=480, method="fft")
    return got, want


@pytest.mark.parametrize("silent", [None, (2400, 9600)],
                         ids=["noise", "silent"])
def test_gcc_features_match_jax(silent):
    """GCC-PHAT of every pair; frames wholly inside the digital silence
    have r = 0 in every bin, so unit phase on both sides: a delta at lag
    0 (the crop's centre), 1 there and 0 at every other lag."""
    got_spec, want_spec = _spec(_mic_clip(11, silent=silent))
    got = Fe.gcc_features(got_spec, n_mels=64).numpy()
    want = np.asarray(JFe.gcc_features(want_spec, n_mels=64))
    assert got.shape == want.shape == (6, 64, 26)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if silent is not None:
        quiet = got[:, :, 8:16]           # frames 8-15 see only zeros
        want_delta = np.zeros((6, 64, 8), np.float32)
        want_delta[:, 32] = 1.0
        np.testing.assert_allclose(quiet, want_delta, rtol=0, atol=1e-6)


@pytest.mark.parametrize("silent", [None, (2400, 9600)],
                         ids=["noise", "silent"])
def test_mic_extract_features_match_jax(silent):
    wav = _mic_clip(12, silent=silent)
    got = Fe.extract_features(torch.from_numpy(wav), mode="mic").numpy()
    want = np.asarray(JFe.extract_features(jnp.asarray(wav), mode="mic",
                                           method="fft"))
    assert got.shape == want.shape == (26, 64, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_mic_extract_features_batch_and_clips_match_jax():
    clips = [_mic_clip(13), _mic_clip(14, silent=(0, 4800)),
             _mic_clip(15, n=9600), _mic_clip(16)]
    batch = np.stack(clips[:2])
    got = Fe.extract_features_batch(torch.from_numpy(batch),
                                    mode="mic").numpy()
    want = np.asarray(JFe.extract_features_batch(jnp.asarray(batch),
                                                 mode="mic", method="fft"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    got = Fe.extract_features_clips(clips, chunk_size=2, device="cpu",
                                    mode="mic")
    want = JFe.extract_features_clips(clips, chunk_size=2, mode="mic",
                                      method="fft")
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[0].shape == (26, 64, 10) and got[2].shape == (21, 64, 10)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kw", [{}, {"d_max": 0.02, "freq_clip_hz": 4000.0}])
def test_salsa_lite_features_match_jax(kw):
    got_spec, want_spec = _spec(_mic_clip(17, silent=(0, 2400)))
    got = Fe.salsa_lite_features(got_spec, **kw).numpy()
    want = np.asarray(JFe.salsa_lite_features(want_spec, **kw))
    assert got.shape == want.shape == (26, 513, 7)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_invalid_mode_raises():
    wav = torch.zeros(4, 4800)
    with pytest.raises(ValueError, match="invalid mode"):
        Fe.extract_features(wav, mode="stereo")
    assert Fe.FEATURE_CHANNELS == {"foa": 7, "mic": 10}


def test_extract_labels_equal(tmp_path):
    path = os.path.join(tmp_path, "fold1_room1_mix001.csv")
    with open(path, "w") as f:
        for fr, cls, azi, ele in [(0, 3, 45, -10), (2, 3, 50, 0),
                                  (2, 7, -170, 30), (9, 11, 90, 80)]:
            f.write(f"{fr},{cls},0,{azi},{ele}\n")
    for max_frames in (None, 20):
        got = Fe.extract_labels(path, n_classes=12, max_frames=max_frames)
        want = JFe.extract_labels(path, n_classes=12, max_frames=max_frames)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames", [40, 70])
def test_preprocess_statistics_and_normalizer_match_jax(frames):
    rng = np.random.RandomState(frames)
    feats = rng.randn(frames, 64, 7).astype(np.float32)
    labels = rng.rand(frames // 5, 48).astype(np.float32)
    got = Fe.preprocess_features_labels(feats, labels, max_label_length=10)
    want = JFe.preprocess_features_labels(feats, labels, max_label_length=10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    stats = Fe.calculate_statistics(got[0])
    want_stats = JFe.calculate_statistics(want[0])
    for g, w in zip(stats, want_stats):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        Fe.apply_normalizer(got[0], *stats),
        np.asarray(JFe.apply_normalizer(want[0], *want_stats)))
    on_tensor = Fe.apply_normalizer(torch.from_numpy(got[0]), *stats)
    np.testing.assert_allclose(on_tensor.numpy(),
                               Fe.apply_normalizer(got[0], *stats),
                               rtol=1e-6, atol=1e-6)
