"""The port's real-time streaming (seld_tpu_torch/inference/streaming.py and
streaming_wav.py) against the JAX package's `StreamingSELD`,
`StreamingFrontEnd` and `StreamingSELDWav` on the same bridged weights and
numpy inputs, and against the port's own trunk-once fast path; one port
counterpart for each of tests/test_streaming.py's tests.

Setup: SS5 at its published widths for [50, 16, 7] windows (win 50, step
5 = time_down, 10 label frames a window), as tests/test_streaming.py builds
it, with random variables (tests/test_torch_model.py::random_variables:
random BatchNorm statistics, so eval BN is not the identity); front-end
geometry 16 mels, n_fft 512, hop 240. Tolerance: 1e-5 absolute on every
emitted sed and doa frame, port against JAX and against the fast path
(f32; both sides differ by summation order only, ~1e-7); feature frames
(dB and IV) to 1e-4 absolute, tests/test_torch_features.py's tolerance
(f32 FFTs in another order, dB values up to ~100).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import random_variables

from seld_tpu.config import get_model_config
from seld_tpu.inference import ensemble_outputs as jax_ensemble
from seld_tpu.inference import streaming as jst
from seld_tpu.inference import streaming_wav as jsw
from seld_tpu.models import build_model as jax_build_model
from seld_tpu.ops.features import extract_features as jax_extract
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.inference import ensemble_outputs
from seld_tpu_torch.inference.streaming import (StreamingSELD,
                                                measure_trunk_halo)
from seld_tpu_torch.inference.streaming_wav import (StreamingFrontEnd,
                                                    StreamingSELDWav)
from seld_tpu_torch.models import build_model
from seld_tpu_torch.ops.features import extract_features

torch.set_num_threads(1)
ATOL = 1e-5
FEATURE_ATOL = 1e-4
SHAPE = (50, 16, 7)
GEOM = dict(win_size=50, step_size=5, time_down=5)
FE = dict(mode="foa", sample_rate=24000, n_mels=16, n_fft=512,
          win_length=480, hop_length=240)


def _pair(shape=SHAPE, seed=1):
    cfg = copy.deepcopy(get_model_config("SS5", search_paths=[]))
    cfg["n_classes"] = 12
    jm = jax_build_model("conv_temporal", shape, cfg)
    v = random_variables(jm, shape, seed=seed)
    model = build_model("conv_temporal", shape, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    return jm, v, model


@pytest.fixture(scope="module")
def ss5():
    return _pair()


def _drive(engine, x, step):
    out = []
    for lo in range(0, x.shape[-3], step):
        out.extend(engine.push(x[..., lo:lo + step, :, :]))
    return out + list(engine.finalize())


def _frames(emits, axis=0):
    return (np.stack([np.asarray(s) for s, _ in emits], axis=axis),
            np.stack([np.asarray(d) for _, d in emits], axis=axis))


def _close(got, want, atol=ATOL, msg=""):
    for g, w in zip(got, want):
        assert g.shape == w.shape, msg
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=msg)


def _fast(model, x):
    sed, doa = ensemble_outputs(model, [x], batch_size=8, fast=True,
                                **GEOM)[0]
    return sed.numpy(), doa.numpy()


def test_streaming_matches_jax_stream_and_fast_path(ss5):
    """A 200-frame clip in ragged pushes of 33, halo measured: every
    emitted frame equals the JAX stream's and the port's fast path."""
    jm, v, model = ss5
    x = np.random.RandomState(2).randn(200, 16, 7).astype(np.float32)
    sp = StreamingSELD(model, (16, 7), chunk=4, **GEOM)
    jsp = jst.StreamingSELD(jm.apply, v, (16, 7), chunk=4, **GEOM)
    assert (sp.halo_t, sp.l_f) == (jsp.halo_t, jsp.l_f)
    got, want = _drive(sp, x, 33), _drive(jsp, x, 33)
    assert len(got) == len(want) == 40
    _close(_frames(got), _frames(want))
    _close(_frames(got), _fast(model, x))


def test_streaming_reset_starts_a_new_clip(ss5):
    jm, v, model = ss5
    sp = StreamingSELD(model, (16, 7), chunk=5, halo=4, **GEOM)
    for seed in (3, 4):
        x = np.random.RandomState(seed).randn(100, 16, 7).astype(np.float32)
        got = _frames(list(sp.push(x)) + list(sp.finalize()))
        want = jax_ensemble(jm.apply, v, [jnp.asarray(x)], batch_size=8,
                            fast=True, **GEOM)[0]
        _close(got, [np.asarray(w) for w in want], msg=f"seed {seed}")
        _close(got, _fast(model, x), msg=f"seed {seed}")
        sp.reset()
        assert sp.state is None and sp._pending.shape[1] == 0


def test_streaming_rejects_bad_geometry(ss5):
    _, _, model = ss5
    with pytest.raises(ValueError, match="step_size == time_down"):
        StreamingSELD(model, (16, 7), win_size=50, step_size=10,
                      time_down=5, halo=4)
    with pytest.raises(ValueError, match="multiple of time_down"):
        StreamingSELD(model, (16, 7), win_size=52, step_size=5,
                      time_down=5, halo=4)
    with pytest.raises(ValueError, match="must be < the window"):
        StreamingSELD(model, (16, 7), halo=10, **GEOM)
    sp = StreamingSELD(model, (16, 7), halo=4, **GEOM)
    with pytest.raises(ValueError, match="expected"):
        sp.push(np.zeros((10, 16, 5), np.float32))


@pytest.mark.parametrize("shape", [SHAPE, (300, 64, 7)],
                         ids=["16-mels", "64-mels"])
def test_halo_equals_jax_and_is_sufficient(shape):
    """The same probe on the same weights gives JAX's halo: 4 trunk frames
    for SS5 at 16 mels and at the challenge's 64; the suffix's trunk equals
    the full trunk beyond it."""
    jm, v, model = _pair(shape)
    halo = measure_trunk_halo(model, shape[1:], time_down=5)
    assert halo == jst.measure_trunk_halo(jm.apply, v, shape[1:],
                                          time_down=5) == 4
    x = torch.from_numpy(np.random.RandomState(5).randn(300, *shape[1:])
                         .astype(np.float32))
    with torch.inference_mode():
        full = model(x[None], stage="trunk")[0]
        suf = model(x[None, 50:], stage="trunk")[0]
    np.testing.assert_allclose(full[10 + halo:].numpy(), suf[halo:].numpy(),
                               rtol=0, atol=ATOL)


def test_streaming_short_clip(ss5):
    """A clip shorter than l_f takes the one-pass offline step."""
    jm, v, model = ss5
    sp = StreamingSELD(model, (16, 7), chunk=20, halo=8, **GEOM)
    assert sp.l_f == (20 + 16) * 5
    x = np.random.RandomState(6).randn(100, 16, 7).astype(np.float32)
    assert sp.push(x) == []
    got = sp.finalize()
    jsp = jst.StreamingSELD(jm.apply, v, (16, 7), chunk=20, halo=8, **GEOM)
    assert jsp.push(x) == []
    want = jsp.finalize()
    assert len(got) == len(want) == 20
    _close(_frames(got), _frames(want))
    _close(_frames(got), _fast(model, x))


def _wav(kind, seed=7):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(4, 48000) * 0.1).astype(np.float32)
    if kind == "silent":
        wav[:, 12000:36000] = 0.0         # a second of digital silence
    return wav


@pytest.mark.parametrize("kind", ["noise", "silent"])
def test_frontend_equals_jax_stream(kind):
    """StreamingFrontEnd in ragged pushes == JAX's on the same samples.
    On noise both equal the offline extraction; with a stretch of digital
    silence they do not: the top-dB floor is taken over each segment,
    whose silent frames sit more than 80 dB under the clip's peak."""
    wav = _wav(kind)
    fe, jfe = StreamingFrontEnd(chunk_frames=20, device="cpu", **FE), \
        jsw.StreamingFrontEnd(chunk_frames=20, **FE)
    got, want = [], []
    for lo in range(0, 48000, 7000):
        got.extend(fe.push(wav[:, lo:lo + 7000]))
        want.extend(jfe.push(wav[:, lo:lo + 7000]))
    got, want = np.stack(got + fe.finalize()), \
        np.stack(want + jfe.finalize())
    assert got.shape == want.shape == (201, 16, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_ATOL)
    offline = extract_features(torch.from_numpy(wav), **FE).numpy()
    np.testing.assert_allclose(
        offline, np.asarray(jax_extract(jnp.asarray(wav), **FE)), rtol=0,
        atol=FEATURE_ATOL)
    if kind == "noise":
        np.testing.assert_allclose(got, offline, rtol=0, atol=FEATURE_ATOL)
    else:
        assert np.abs(got - offline).max() > 1.0


def test_wav_end_to_end_equals_jax_and_offline(ss5):
    """Raw audio through StreamingSELDWav == JAX's StreamingSELDWav, and ==
    offline extract + crop + normalize + the fast path."""
    jm, v, model = ss5
    wav = _wav("noise", seed=8)
    feats = extract_features(torch.from_numpy(wav), **FE).numpy()[:200]
    mean, std = feats.mean(axis=0), feats.std(axis=0) + 1e-6
    kw = dict(normalizer=(mean, std), win_size=50, time_down=5, chunk=4,
              halo=4, n_mels=16, n_fft=512, win_length=480, hop_length=240)
    sw = StreamingSELDWav(model, **kw)
    jsw_ = jsw.StreamingSELDWav(jm.apply, v, **kw)
    got, want = [], []
    for lo in range(0, 48000, 9600):
        got.extend(sw.push(wav[:, lo:lo + 9600]))
        want.extend(jsw_.push(wav[:, lo:lo + 9600]))
    got, want = got + sw.finalize(), want + jsw_.finalize()
    assert len(got) == len(want) == 40
    _close(_frames(got), _frames(want))
    _close(_frames(got), _fast(model, (feats - mean) / std))


def test_mic_frontend_equals_jax_stream():
    """Mode "mic" (4 log-mel + 6 GCC-PHAT) streamed in ragged pushes ==
    JAX's stream == offline extraction (GCC is frame-local, and noise
    spans less than 80 dB)."""
    wav = _wav("noise", seed=10)
    fe_kw = {**FE, "mode": "mic"}
    fe, jfe = StreamingFrontEnd(chunk_frames=20, device="cpu", **fe_kw), \
        jsw.StreamingFrontEnd(chunk_frames=20, **fe_kw)
    got, want = [], []
    for lo in range(0, 48000, 7000):
        got.extend(fe.push(wav[:, lo:lo + 7000]))
        want.extend(jfe.push(wav[:, lo:lo + 7000]))
    got, want = np.stack(got + fe.finalize()), \
        np.stack(want + jfe.finalize())
    assert got.shape == want.shape == (201, 16, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_ATOL)
    offline = extract_features(torch.from_numpy(wav), **fe_kw).numpy()
    np.testing.assert_allclose(got, offline, rtol=0, atol=FEATURE_ATOL)


def test_mic_wav_end_to_end_equals_jax_and_offline():
    """StreamingSELDWav in mode "mic" on a 10-channel SS5 == JAX's, and
    == offline extract + crop + normalize + the fast path."""
    jm, v, model = _pair(shape=(50, 16, 10), seed=2)
    wav = _wav("noise", seed=12)
    fe_kw = dict(n_mels=16, n_fft=512, win_length=480, hop_length=240)
    feats = extract_features(torch.from_numpy(wav), mode="mic",
                             **fe_kw).numpy()[:200]
    mean, std = feats.mean(axis=0), feats.std(axis=0) + 1e-6
    kw = dict(normalizer=(mean, std), mode="mic", win_size=50, time_down=5,
              chunk=4, halo=4, **fe_kw)
    sw = StreamingSELDWav(model, **kw)
    jsw_ = jsw.StreamingSELDWav(jm.apply, v, **kw)
    assert sw.seld.feat_shape == jsw_.seld.feat_shape == (16, 10)
    got, want = [], []
    for lo in range(0, 48000, 9600):
        got.extend(sw.push(wav[:, lo:lo + 9600]))
        want.extend(jsw_.push(wav[:, lo:lo + 9600]))
    got, want = got + sw.finalize(), want + jsw_.finalize()
    assert len(got) == len(want) == 40
    _close(_frames(got), _frames(want))
    _close(_frames(got), _fast(model, (feats - mean) / std))


def test_multi_stream_lockstep_equals_independent_and_jax(ss5):
    """n_streams=3: one device step a tick == three single streams == the
    JAX package's lockstep engine."""
    jm, v, model = ss5
    clips = np.random.RandomState(9).randn(3, 150, 16, 7).astype(np.float32)
    sp = StreamingSELD(model, (16, 7), chunk=4, halo=4, n_streams=3, **GEOM)
    jsp = jst.StreamingSELD(jm.apply, v, (16, 7), chunk=4, halo=4,
                            n_streams=3, **GEOM)
    got, want = _drive(sp, clips, 40), _drive(jsp, clips, 40)
    assert len(got) == len(want) == 30
    got = _frames(got, axis=1)                      # [3, 30, ...]
    _close(got, _frames(want, axis=1))
    one = StreamingSELD(model, (16, 7), chunk=4, halo=4, **GEOM)
    for k in range(3):
        one.reset()
        _close([g[k] for g in got], _frames(_drive(one, clips[k], 40)),
               msg=f"stream {k}")


def test_streaming_finalize_error_is_retryable(ss5):
    _, _, model = ss5
    sp = StreamingSELD(model, (16, 7), chunk=4, halo=4, **GEOM)
    sp.push(np.zeros((52, 16, 7), np.float32))     # not a multiple of 5
    with pytest.raises(ValueError, match="multiple of"):
        sp.finalize()
    sp.push(np.zeros((3, 16, 7), np.float32))      # pad to 55
    assert len(sp.finalize()) == 11                 # 55 // 5 frames
    assert sp.finalize() == []
    with pytest.raises(RuntimeError, match="reset"):
        sp.push(np.zeros((5, 16, 7), np.float32))
    sp.reset()
    sp.push(np.zeros((45, 16, 7), np.float32))     # shorter than a window
    with pytest.raises(ValueError, match="shorter than one window"):
        sp.finalize()


def test_frontend_rejects_unsigned_and_casts_blocks():
    fe = StreamingFrontEnd(n_mels=16, n_fft=512, win_length=480,
                           hop_length=240, chunk_frames=20, device="cpu")
    with pytest.raises(ValueError, match="unsigned"):
        fe.push(np.zeros((4, 100), np.uint8))
    fe.push(np.zeros((4, 100), np.float64))
    fe.push(np.zeros((4, 100), np.float32))
    assert fe._pending.dtype == np.float32
    with pytest.raises(ValueError, match="no samples|multiple"):
        StreamingFrontEnd(n_mels=16, device="cpu").finalize()
    # signed PCM is scaled as the JAX package scales it
    pcm = (np.random.RandomState(1).randn(4, 2400) * 3000).astype(np.int16)
    fe.reset()
    jfe = jsw.StreamingFrontEnd(n_mels=16, n_fft=512, win_length=480,
                                hop_length=240, chunk_frames=20)
    got = fe.push(pcm) + fe.finalize()
    want = jfe.push(pcm) + jfe.finalize()
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=FEATURE_ATOL)


def test_frontend_double_finalize_is_a_clean_error():
    fe = StreamingFrontEnd(n_mels=16, n_fft=512, win_length=480,
                           hop_length=240, chunk_frames=20, device="cpu")
    fe.push(np.random.RandomState(0).randn(4, 2400).astype(np.float32))
    assert len(fe.finalize()) == 11  # 2400 // 240 + 1
    with pytest.raises(ValueError, match="already finalized"):
        fe.finalize()
    fe.reset()
    fe.push(np.zeros((4, 2400), np.float32))
    assert len(fe.finalize()) == 11  # reset() starts a new clip


def test_predict_wav_stream_csvs_equal_fast(tmp_path):
    """predict_wav --stream (StreamingSELDWav, 1-s pushes of raw samples)
    writes the same predictions as --fast (offline features, trunk-once)
    from the same checkpoint on the same wavs (tests/test_cli.py's
    journey), in-process on the CPU."""
    import json
    import os
    import wave

    from seld_tpu_torch import predict_wav
    from seld_tpu_torch.train.checkpoint import save_checkpoint
    from seld_tpu_torch.train.optimizers import adabelief
    from seld_tpu_torch.train.train_state import TrainState

    wav_dir = tmp_path / "foa_dev"
    wav_dir.mkdir()
    rng = np.random.RandomState(1)
    for fold in (1, 5, 6):
        data = np.clip(rng.randn(24000 * 12, 4) * 0.05 * 32767, -32767,
                       32767).astype(np.int16)
        with wave.open(str(wav_dir / f"fold{fold}_room1_mix001.wav"),
                       "wb") as w:
            w.setnchannels(4)
            w.setsampwidth(2)
            w.setframerate(24000)
            w.writeframes(data.tobytes())
    cfg = {"filters": 4, "first_kernel_size": 7, "first_pool_size": [5, 4],
           "n_classes": 12,
           "BLOCK0": "bidirectional_GRU_block", "BLOCK0_ARGS": {"units": [8]},
           "SED": "simple_dense_block", "SED_ARGS": {"units": [8]},
           "DOA": "simple_dense_block", "DOA_ARGS": {"units": [8]}}
    cfg_path = tmp_path / "ct.json"
    cfg_path.write_text(json.dumps(cfg))
    model = build_model("conv_temporal", (300, 64, 7), cfg, seed=2,
                        device="cpu")
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), "bestscore_1.0",
                           TrainState(model, adabelief(
                               list(model.parameters()), 1e-3)))
    np.savez(tmp_path / "normalizer.npz",
             mean=np.zeros((64, 7), np.float32),
             std=np.ones((64, 7), np.float32))
    common = ["--wav_dir", str(wav_dir), "--model_config", str(cfg_path),
              "--ckpt", ckpt, "--normalizer", str(tmp_path / "normalizer.npz"),
              "--thresholds", "0.5", "--max_label_frames", "120",
              "--device", "cpu"]
    for mode in ("fast", "stream"):
        predict_wav.main(common + [f"--{mode}", "--output_path",
                                   str(tmp_path / mode)])
    names = sorted(os.listdir(tmp_path / "fast"))
    assert len(names) == 3 and names == sorted(os.listdir(tmp_path /
                                                          "stream"))
    rows = 0
    for name in names:
        fa = [ln.split(",") for ln in
              (tmp_path / "fast" / name).read_text().splitlines()]
        fb = [ln.split(",") for ln in
              (tmp_path / "stream" / name).read_text().splitlines()]
        assert len(fa) == len(fb), name
        rows += len(fa)
        for ra, rb in zip(fa, fb):
            assert ra[:2] == rb[:2], (name, ra, rb)     # frame, class
            np.testing.assert_allclose([float(x) for x in ra[2:]],
                                       [float(x) for x in rb[2:]],
                                       atol=1e-3, err_msg=name)
    assert rows > 0
