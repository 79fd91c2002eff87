"""The port's TDM (track-density modulation) pieces
(seld_tpu_torch/data/{tdm,tdm_pipeline}.py) against the JAX package's
(seld_tpu/data/{tdm,tdm_pipeline}.py) on the same numpy clips and the same
RandomState.

data/tdm.py is a copy (numpy): the event banks, the pasted clips, the
pasted labels and the RandomState's state afterwards must be bitwise
equal. The curriculum's schedule must be equal. `make_tdm_trainset`'s
labels must be equal and its normalised features agree to 1e-3, the
tolerance of tests/test_torch_feed.py's normalised wav features (the
front-end agrees to 1e-4 and the per-(freq, chan) std amplifies it).
"""
import numpy as np
import pytest
import torch

from seld_tpu.data import tdm as JD
from seld_tpu.data import tdm_pipeline as JP
from seld_tpu_torch.data import tdm as D
from seld_tpu_torch.data import tdm_pipeline as P

torch.set_num_threads(1)
SR, N_CLASSES, FRAMES = 24000, 12, 100      # 10-s clips


def _clips(n=3, seed=0):
    """Noise clips whose labels hold single-class runs of 20-35 frames
    (bank events) and a two-class stretch (not one)."""
    rng = np.random.RandomState(seed)
    wavs, labels = [], []
    for i in range(n):
        wavs.append((rng.randn(4, FRAMES * 2400) * 0.05).astype(np.float32))
        lab = np.zeros((FRAMES, 4 * N_CLASSES), np.float32)
        for start, length, cls in ((2, 20 + 5 * i, i % N_CLASSES),
                                   (40, 35, (i + 4) % N_CLASSES)):
            lab[start:start + length, cls] = 1.0
            lab[start:start + length, N_CLASSES + cls] = 0.5
        lab[80:86, 7] = lab[80:86, 8] = 1.0
        labels.append(lab)
    return wavs, labels


def test_build_event_banks_equal_jax():
    wavs, labels = _clips()
    clips = list(zip(wavs, labels))
    got = D.build_event_banks(clips, sr=SR)
    want = JD.build_event_banks(clips, sr=SR)
    assert sum(x.shape[1] > 0 for x in got[0]) == 6
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g, w)
    events = D.extract_single_class_events(wavs[1], labels[1], sr=SR)
    want_events = JD.extract_single_class_events(wavs[1], labels[1], sr=SR)
    assert [e[0] for e in events] == [e[0] for e in want_events] == [1, 5]


@pytest.mark.parametrize("overlap_num,overlap_sec", [(1, 1), (3, 3)])
def test_tdm_aug_equal_jax_with_the_rng_state(overlap_num, overlap_sec):
    wavs, labels = _clips()
    banks = D.build_event_banks(list(zip(wavs, labels)), sr=SR)
    kw = dict(sr=SR, max_overlap_num=overlap_num, max_overlap_sec=overlap_sec,
              min_overlap_sec=0.5)
    rng, jrng = np.random.RandomState(7), np.random.RandomState(7)
    gx, gy = D.tdm_aug([w.copy() for w in wavs], [y.copy() for y in labels],
                       *banks, rng, **kw)
    wx, wy = JD.tdm_aug([w.copy() for w in wavs], [y.copy() for y in labels],
                        *banks, jrng, **kw)
    for g, w in zip(gx + gy, wx + wy):
        np.testing.assert_array_equal(g, w)
    assert any(not np.array_equal(g, y) for g, y in zip(gy, labels))
    got_state, want_state = rng.get_state(), jrng.get_state()
    np.testing.assert_array_equal(got_state[1], want_state[1])
    assert got_state[2:] == want_state[2:]


def test_curriculum_schedule_equals_jax():
    got, want = P.TDMCurriculum(), JP.TDMCurriculum()
    schedule = []
    for epoch in range(0, 60):
        got.advance(epoch)
        want.advance(epoch)
        assert (got.overlap_num, got.overlap_sec) == (want.overlap_num,
                                                      want.overlap_sec)
        schedule.append((got.overlap_num, got.overlap_sec))
    # overlap_sec resets to 1 on each bump of overlap_num (reference)
    assert schedule[22:28] == [(1, 2), (1, 2), (1, 3), (1, 3), (2, 1),
                               (2, 1)]
    assert schedule[-1] == (3, 3)


def test_make_tdm_trainset_matches_jax():
    wavs, labels = _clips(4, seed=1)
    banks = D.build_event_banks(list(zip(wavs, labels)), sr=SR)
    curriculum = P.TDMCurriculum()
    timing = {}
    got = P.make_tdm_trainset(wavs, labels, banks, np.random.RandomState(3),
                              batch_size=2, curriculum=curriculum,
                              device="cpu", timing=timing)
    want = JP.make_tdm_trainset(wavs, labels, banks,
                                np.random.RandomState(3), batch_size=2,
                                curriculum=JP.TDMCurriculum())
    assert got.x.shape == want.x.shape and got.x.shape[1:] == (300, 64, 7)
    assert got.x.dtype == np.float32
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=0, atol=1e-3)
    assert set(timing) == {"paste_s", "extract_s", "normalize_window_s"}
    assert all(v >= 0 for v in timing.values())
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
    # the input clips stay untouched (the paste works on copies)
    np.testing.assert_array_equal(labels[0], _clips(4, seed=1)[1][0])


def test_extract_clip_features_pads_and_crops_like_jax():
    rng = np.random.RandomState(2)
    wavs = [(rng.randn(4, 24000) * 0.05).astype(np.float32),
            (rng.randn(4, 24000) * 0.05).astype(np.float32)]
    for frames in (80, 30):
        got = P.extract_clip_features(wavs, max_frames=frames, device="cpu")
        want = JP.extract_clip_features(wavs, max_frames=frames)
        assert got.shape == want.shape == (2, frames, 64, 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
