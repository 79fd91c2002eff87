"""The port's feed (seld_tpu_torch/data/{loader,device_dataset,
wav_pipeline}.py) against the JAX package's on the same data: FOA,
microphone-array and joint FOA+MIC (17-channel) wav splits, and the
offline joint source.

Batches, windows, wav loading and labels are copies and must be exactly
equal (the shuffle is the same numpy RandomState call sequence). The wav
pipeline's raw features agree to 1e-4 (the front-end's tolerance,
tests/test_torch_frontend.py) and its normalised features to 1e-3: the
statistics divide by the train split's per-(freq, chan) std, which
amplifies the front-end's rounding differences.
"""
import os
import wave

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from seld_tpu.data import loader as JL
from seld_tpu.data import wav_pipeline as JW
from seld_tpu.data.device_dataset import DeviceDataset as JaxDeviceDataset
from seld_tpu.parallel import make_mesh
from seld_tpu_torch.data import loader as L
from seld_tpu_torch.data import wav_pipeline as W
from seld_tpu_torch.data.device_dataset import LAUNCHES_PER_BATCH, \
    DeviceDataset
from seld_tpu_torch.ops import features as Fe

torch.set_num_threads(1)
SR = 24000


def _data(n=24, t=10, f=4, c=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, t, f, c).astype(np.float32),
            rng.randn(n, 5, 8).astype(np.float32))


def _mesh():
    return make_mesh("data:1", devices=jax.devices()[:1])


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(gx), np.asarray(wx))
        np.testing.assert_array_equal(np.asarray(gy), np.asarray(wy))


def test_train_batches_equal_jax_for_the_same_seed():
    x, y = _data()
    want_host = JL.SeldDataset(x, y, batch_size=8, loop_time=2, seed=3)
    want_dev = JaxDeviceDataset(x, y, 8, _mesh(), loop_time=2, seed=3)
    host = L.SeldDataset(x, y, batch_size=8, loop_time=2, seed=3)
    dev = DeviceDataset(x, y, 8, "cpu", loop_time=2, seed=3)
    assert len(host) == len(dev) == len(want_dev) == 6
    for _ in range(2):                     # two epochs: the shuffle advances
        want = list(want_host)
        _assert_batches_equal(host, want)
        _assert_batches_equal(dev, want)
        _assert_batches_equal(want_dev, want)


def test_eval_batches_equal_jax():
    x, y = _data(n=30)                     # 3 clips x 10 windows
    want = list(JL.SeldDataset(x, y, batch_size=99, train=False,
                               windows_per_clip=10))
    _assert_batches_equal(L.SeldDataset(x, y, batch_size=99, train=False,
                                        windows_per_clip=10), want)
    dev = DeviceDataset(x, y, 10, "cpu", train=False)
    _assert_batches_equal(dev, want)
    _assert_batches_equal(dev, want)       # deterministic across epochs
    _assert_batches_equal(JaxDeviceDataset(x, y, 10, _mesh(), train=False),
                          want)
    with pytest.raises(ValueError, match="whole number"):
        DeviceDataset(x, y, 7, "cpu", train=False)
    # sharded over two ranks: each stages half of every clip, and the
    # ranks' rows of a batch, in rank order, are the whole clip
    from seld_tpu_torch.parallel.mesh import Mesh
    shards = [list(DeviceDataset(x, y, 10, "cpu", train=False, mesh=Mesh(
        axes={"data": 2}, world=2, rank=r, data_size=2, data_index=r,
        device=torch.device("cpu")))) for r in range(2)]
    _assert_batches_equal(
        [tuple(torch.cat(parts) for parts in zip(*batches))
         for batches in zip(*shards)], want)


def test_from_clips_bf16_and_index_matrix():
    x, y = _data(n=30)
    clips_x = [x[i * 10:(i + 1) * 10].reshape(100, 4, 3) for i in range(3)]
    clips_y = [y[i * 10:(i + 1) * 10].reshape(50, 8) for i in range(3)]
    dev = DeviceDataset.from_clips(clips_x, clips_y, batch_size=99,
                                   device="cpu", train=False,
                                   label_window_size=5,
                                   feature_dtype=torch.bfloat16)
    want = JaxDeviceDataset.from_clips(clips_x, clips_y, batch_size=99,
                                       mesh=_mesh(), train=False,
                                       label_window_size=5,
                                       feature_dtype=ml_dtypes.bfloat16)
    assert dev.batch_size == want.batch_size == 10 and len(dev) == 3
    gx, gy = dev.device_arrays
    wx, wy = (np.asarray(a) for a in want.device_arrays)
    assert gx.dtype == torch.bfloat16
    np.testing.assert_array_equal(gx.float().numpy(), wx.astype(np.float32))
    np.testing.assert_array_equal(gy.numpy(), wy)
    assert dev.hbm_bytes() == want.hbm_bytes()
    train = DeviceDataset(x, y, 8, "cpu", loop_time=2, seed=1)
    want = JaxDeviceDataset(x, y, 8, _mesh(), loop_time=2, seed=1)
    idx = train.epoch_index_matrix()
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (7, 8)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(want.epoch_index_matrix()))
    assert LAUNCHES_PER_BATCH == 1


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_device_dataset_gathers_each_batch_in_one_call(monkeypatch, train):
    """One gather_batch call per batch, for x and y with the same ids row,
    and the batches JAX's DeviceDataset gives."""
    from seld_tpu_torch.data import device_dataset as DD
    x, y = _data(n=30)
    calls = []
    gather_batch = DD.gather_batch

    def counting(arrays, ids):
        calls.append((len(arrays), tuple(ids.shape)))
        return gather_batch(arrays, ids)
    kw = dict(loop_time=2, seed=5) if train else dict(train=False)
    b = 8 if train else 10
    want = list(JaxDeviceDataset(x, y, b, _mesh(), **kw))
    dev = DeviceDataset(x, y, b, "cpu", **kw)
    monkeypatch.setattr(DD, "gather_batch", counting)
    got = list(dev)
    _assert_batches_equal(got, want)
    assert calls == [(2, (b,))] * len(dev) == [(2, (b,))] * len(want)
    assert len(calls) * LAUNCHES_PER_BATCH == len(dev)


def test_window_clips_equal_jax():
    rng = np.random.RandomState(5)
    feats = [rng.randn(600, 4, 3).astype(np.float32) for _ in range(3)]
    labels = [rng.randn(120, 8).astype(np.float32) for _ in range(3)]
    for got, want in zip(L.window_clips(feats, labels),
                         JL.window_clips(feats, labels)):
        np.testing.assert_array_equal(got, want)
    bf16 = L.cast_clips(feats, torch.bfloat16)
    gx, gy = L.window_clips(bf16, labels)
    wx, wy = JL.window_clips([f.astype(ml_dtypes.bfloat16) for f in feats],
                             labels)
    np.testing.assert_array_equal(gx.float().numpy(), wx.astype(np.float32))
    np.testing.assert_array_equal(gy, wy)
    with pytest.raises(ValueError, match="integer multiple"):
        L.window_clips([feats[0][:599]], [labels[0]])


def _write_wav(path, samples, width=2):
    dtype = {2: np.int16, 4: np.int32}[width]
    data = (np.clip(samples, -1, 1) * np.iinfo(dtype).max).astype(dtype)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(width)
        w.setframerate(SR)
        w.writeframes(data.tobytes())


def _make_wav_tree(root, folds=(1, 1, 5, 6), seconds=1.0):
    """tests/test_wav_native.py's tree: 4-channel noise clips and label
    CSVs named fold<k>_room1_mix<i>."""
    rng = np.random.RandomState(3)
    wav_dir, meta_dir = root / "foa_dev", root / "metadata_dev"
    os.makedirs(wav_dir)
    os.makedirs(meta_dir)
    for i, fold in enumerate(folds):
        name = f"fold{fold}_room1_mix{i:03d}"
        _write_wav(wav_dir / f"{name}.wav",
                   rng.randn(int(SR * seconds), 4) * 0.05)
        with open(meta_dir / f"{name}.csv", "w") as f:
            for fr in range(2, 12):
                f.write(f"{fr},{(i + 2) % 12},0,45,-10\n")
    return str(wav_dir), str(meta_dir)


def _make_mic_dir(root, folds=(1, 1, 5, 6), seconds=1.0, skip=None):
    """mic_dev beside foa_dev: the same stems, independent noise (the
    stem at index `skip` left out)."""
    rng = np.random.RandomState(4)
    mic_dir = root / "mic_dev"
    os.makedirs(mic_dir)
    for i, fold in enumerate(folds):
        if i != skip:
            _write_wav(mic_dir / f"fold{fold}_room1_mix{i:03d}.wav",
                       rng.randn(int(SR * seconds), 4) * 0.05)
    return str(mic_dir)


def test_mic_wav_feature_splits_match_jax(tmp_path):
    """mode "mic": 4 log-mel + 6 GCC-PHAT channels from mic_dev."""
    _, meta_dir = _make_wav_tree(tmp_path)
    mic_dir = _make_mic_dir(tmp_path)
    kwargs = dict(n_classes=12, max_label_length=50, mode="mic")
    raw, _ = W.wav_feature_splits(mic_dir, meta_dir, normalize=False,
                                  device="cpu", **kwargs)
    want_raw, _ = JW.wav_feature_splits(mic_dir, meta_dir, normalize=False,
                                        **kwargs)
    got, stats = W.wav_feature_splits(mic_dir, meta_dir, device="cpu",
                                      **kwargs)
    want, want_stats = JW.wav_feature_splits(mic_dir, meta_dir, **kwargs)
    for mode in ("train", "val", "test"):
        assert got[mode][0].shape[-1] == 10
        np.testing.assert_allclose(raw[mode][0], want_raw[mode][0],
                                   rtol=0, atol=1e-4, err_msg=mode)
        np.testing.assert_allclose(got[mode][0], np.asarray(want[mode][0]),
                                   rtol=0, atol=1e-3, err_msg=mode)
        np.testing.assert_array_equal(got[mode][1], want[mode][1])
    for g, w in zip(stats, want_stats):
        assert g.shape == np.asarray(w).shape == (1, 64, 10)


def test_joint_wav_feature_splits_match_jax(tmp_path):
    """foa_dev + mic_dev side by side: FOA's labels, 17 channels, each
    modality normalised by its own train-split statistics."""
    wav_dir, meta_dir = _make_wav_tree(tmp_path)
    mic_dir = _make_mic_dir(tmp_path)
    kwargs = dict(n_classes=12, max_label_length=50)
    got, stats = W.joint_wav_feature_splits(wav_dir, mic_dir, meta_dir,
                                            device="cpu", **kwargs)
    want, want_stats = JW.joint_wav_feature_splits(wav_dir, mic_dir,
                                                   meta_dir, **kwargs)
    foa, _ = W.wav_feature_splits(wav_dir, meta_dir, device="cpu", **kwargs)
    for mode in ("train", "val", "test"):
        assert got[mode][0].shape[-1] == 17
        np.testing.assert_allclose(got[mode][0], want[mode][0], rtol=0,
                                   atol=1e-3, err_msg=mode)
        np.testing.assert_array_equal(got[mode][1], want[mode][1])
        np.testing.assert_array_equal(got[mode][0][..., :7], foa[mode][0])
    for g, w in zip(stats, want_stats):
        assert g.shape == w.shape == (1, 64, 17)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


def test_joint_splits_refuse_diverging_clip_stems(tmp_path):
    wav_dir, meta_dir = _make_wav_tree(tmp_path)
    mic_dir = _make_mic_dir(tmp_path, skip=1)
    for fn in (W.joint_wav_feature_splits, JW.joint_wav_feature_splits):
        kw = {"device": "cpu"} if fn is W.joint_wav_feature_splits else {}
        with pytest.raises(ValueError, match="diverge at "
                           "'fold1_room1_mix001' vs None"):
            fn(wav_dir, mic_dir, meta_dir, n_classes=12, **kw)


def test_load_joint_seldnet_data_equal_jax(tmp_path):
    """The offline --use_both source: feat_label's FOA and MIC .npy
    features joined on the channel axis, FOA's labels."""
    rng = np.random.RandomState(5)
    root = tmp_path / "feat_label"
    for sub in ("foa_dev_norm", "foa_dev_label", "mic_dev_norm",
                "mic_dev_label"):
        os.makedirs(root / sub)
    for i, fold in enumerate((1, 2, 5, 6)):
        name = f"fold{fold}_room1_mix{i:03d}.npy"
        np.save(root / "foa_dev_norm" / name,
                rng.randn(30, 64 * 7).astype(np.float32))
        np.save(root / "mic_dev_norm" / name,
                rng.randn(30, 64 * 10).astype(np.float32))
        for sub in ("foa_dev_label", "mic_dev_label"):
            np.save(root / sub / name, rng.rand(6, 48).astype(np.float32))
    for mode in ("train", "val", "test"):
        got = L.load_joint_seldnet_data(str(root), mode=mode)
        want = JL.load_joint_seldnet_data(str(root), mode=mode)
        assert len(got[0]) == len(want[0]) == (2 if mode == "train" else 1)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_array_equal(g, w)
        assert got[0][0].shape == (30, 64, 17)
    os.remove(root / "mic_dev_norm" / "fold2_room1_mix001.npy")
    os.remove(root / "mic_dev_label" / "fold2_room1_mix001.npy")
    with pytest.raises(ValueError, match="clip counts differ"):
        L.load_joint_seldnet_data(str(root), mode="train")


@pytest.mark.parametrize("pcm", [False, True])
def test_load_wav_clips_equal_jax(tmp_path, pcm):
    wav_dir, meta_dir = _make_wav_tree(tmp_path)
    _write_wav(tmp_path / "foa_dev" / "fold2_room1_mix009.wav",
               np.random.RandomState(9).randn(SR // 2, 4) * 0.1, width=4)
    with open(tmp_path / "metadata_dev" / "fold2_room1_mix009.csv",
              "w") as f:
        f.write("3,1,0,10,20\n")
    got = L.load_wav_clips(wav_dir, meta_dir, "train", n_classes=12,
                           pcm=pcm)
    want = JL.load_wav_clips(wav_dir, meta_dir, "train", n_classes=12,
                             pcm=pcm)
    assert len(got[0]) == len(want[0]) == 3
    assert {w.dtype for w in got[0]} == (
        {np.dtype(np.int16), np.dtype(np.int32)} if pcm
        else {np.dtype(np.float32)})
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g, w)
    os.remove(tmp_path / "metadata_dev" / "fold2_room1_mix009.csv")
    with pytest.raises(ValueError, match="no label CSV"):
        L.load_wav_clips(wav_dir, meta_dir, "train")


def test_wav_feature_splits_match_jax(tmp_path):
    wav_dir, meta_dir = _make_wav_tree(tmp_path)
    kwargs = dict(n_classes=12, max_label_length=50)
    raw, _ = W.wav_feature_splits(wav_dir, meta_dir, normalize=False,
                                  device="cpu", **kwargs)
    want_raw, _ = JW.wav_feature_splits(wav_dir, meta_dir, normalize=False,
                                        **kwargs)
    got, stats = W.wav_feature_splits(wav_dir, meta_dir, device="cpu",
                                      **kwargs)
    want, want_stats = JW.wav_feature_splits(wav_dir, meta_dir, **kwargs)
    assert set(got) == set(want) == {"train", "val", "test"}
    for mode in got:
        np.testing.assert_allclose(raw[mode][0], want_raw[mode][0],
                                   rtol=0, atol=1e-4, err_msg=mode)
        np.testing.assert_allclose(got[mode][0], np.asarray(want[mode][0]),
                                   rtol=0, atol=1e-3, err_msg=mode)
        np.testing.assert_array_equal(got[mode][1], want[mode][1])
    for g, w in zip(stats, want_stats):
        assert g.shape == np.asarray(w).shape == (1, 64, 7)


def test_make_wav_datasets_geometry_matches_jax(tmp_path):
    wav_dir, meta_dir = _make_wav_tree(tmp_path)
    kwargs = dict(batch=2, loop_time=1, n_classes=12, max_label_length=60)
    datasets, splits, stats = W.make_wav_datasets(wav_dir, meta_dir,
                                                  device="cpu", **kwargs)
    want_ds, want_splits, _ = JW.make_wav_datasets(wav_dir, meta_dir,
                                                   **kwargs)
    assert stats[0].shape[-2:] == (64, 7)
    for mode in ("train", "val", "test"):
        assert len(datasets[mode]) == len(want_ds[mode])
        assert splits[mode][0].shape == want_splits[mode][0].shape
        np.testing.assert_array_equal(splits[mode][1], want_splits[mode][1])
    x, y = next(iter(datasets["train"]))
    assert x.shape == (2, 300, 64, 7) and y.shape == (2, 60, 48)
    assert splits["train"][1][0][2].reshape(4, 12)[0, 2] == 1.0
    bf16, _, _ = W.make_wav_datasets(wav_dir, meta_dir, device="cpu",
                                     feature_dtype=torch.bfloat16, **kwargs)
    assert bf16["train"].x.dtype == torch.bfloat16
    # the joint 17-channel set from foa_dev + mic_dev (mode is ignored)
    mic_dir = _make_mic_dir(tmp_path)
    datasets, splits, stats = W.make_wav_datasets(
        wav_dir, meta_dir, mic_dir=mic_dir, mode="mic", device="cpu",
        **kwargs)
    want_ds, want_splits, want_stats = JW.make_wav_datasets(
        wav_dir, meta_dir, mic_dir=mic_dir, **kwargs)
    assert stats[0].shape == stats[1].shape == (1, 64, 17)
    for mode in ("train", "val", "test"):
        assert len(datasets[mode]) == len(want_ds[mode])
        np.testing.assert_allclose(splits[mode][0], want_splits[mode][0],
                                   rtol=0, atol=1e-3, err_msg=mode)
        np.testing.assert_array_equal(splits[mode][1], want_splits[mode][1])
    x, y = next(iter(datasets["train"]))
    assert x.shape == (2, 300, 64, 17) and y.shape == (2, 60, 48)


def test_device_iterator_cpu_path_yields_host_batches_in_order():
    x, y = _data(n=12)
    host = L.SeldDataset(x, y, batch_size=4, loop_time=1, seed=2)
    want = list(L.SeldDataset(x, y, batch_size=4, loop_time=1, seed=2))
    got = list(L.DeviceIterator(host, "cpu"))
    assert all(isinstance(a, torch.Tensor) for b in got for a in b)
    _assert_batches_equal(got, want)


def test_extract_features_clips_keeps_dtype_buckets_apart():
    rng = np.random.RandomState(0)
    a = (rng.uniform(-0.5, 0.5, (4, 4800)) * 32767).astype(np.int16)
    b = a.astype(np.int32) * 65536            # the same signal in int32
    got = Fe.extract_features_clips([a, b], device="cpu")
    np.testing.assert_allclose(got[0], got[1], rtol=0, atol=1e-4)
