"""Host-side data pipeline (seld_tpu/data/loader.py).

  load fold .npy clips (FOA, or FOA+MIC joined: `load_joint_seldnet_data`)
  or raw wavs (fold digit parsed from the filename)
  -> window into [300-feature / 60-label]-frame samples
  -> per-epoch sample-level shuffle + fixed-size batches (`SeldDataset`)
  -> `DeviceIterator`: pinned host buffers copied to the card on a side
     stream while the current batch computes.

Augmentations are not applied here (data/transforms.py). Eval batches are
whole clips (600 / 60 = 10 windows per clip).

Windows are numpy arrays, or torch tensors when the features were cast to a
dtype numpy does not have (bf16): `window_clips` and `SeldDataset` take
either.
"""
from __future__ import annotations

import collections
import os
from glob import glob
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

SPLITS = {"train": [1, 2, 3, 4], "val": [5], "test": [6]}


def _fold_of(path: str) -> int:
    """Fold digit = 5th char of the basename (fold1_...)."""
    return int(os.path.basename(path)[4])


def _pair_by_basename(a_paths, b_paths, b_dir_desc: str):
    """Pair two file lists by basename stem; raise on any missing partner
    (positional pairing would misalign every clip when the sets differ)."""
    b_by_name = {os.path.splitext(os.path.basename(p))[0]: p
                 for p in b_paths}
    pairs = []
    for a in a_paths:
        name = os.path.splitext(os.path.basename(a))[0]
        if name not in b_by_name:
            raise ValueError(f"no {b_dir_desc} file for {name}")
        pairs.append((a, b_by_name[name]))
    return pairs


def load_seldnet_data(feat_path: str, label_path: str, mode: str = "train",
                      n_freq_bins: int = 64
                      ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Load per-fold feature/label .npy clips for a split (name-matched)."""
    assert mode in SPLITS
    if not os.path.exists(feat_path):
        raise ValueError(f"no such feat_path ({feat_path}) exists")
    if not os.path.exists(label_path):
        raise ValueError(f"no such label_path ({label_path}) exists")
    feat_files = [f for f in sorted(glob(os.path.join(feat_path, "*.npy")))
                  if _fold_of(f) in SPLITS[mode]]
    label_files = [f for f in sorted(glob(os.path.join(label_path, "*.npy")))
                   if _fold_of(f) in SPLITS[mode]]
    pairs = _pair_by_basename(feat_files, label_files, "label")

    features = [np.load(f).astype("float32") for f, _ in pairs]
    labels = [np.load(lab).astype("float32") for _, lab in pairs]

    if features and features[0].ndim == 2:
        features = [np.transpose(
            f.reshape(f.shape[0], -1, n_freq_bins), (0, 2, 1))
            for f in features]
    return features, labels


def load_joint_seldnet_data(feat_label_root: str, mode: str = "train",
                            n_freq_bins: int = 64):
    """FOA + MIC features concatenated on the channel axis -> 17 channels
    (4 FOA mel + 3 IV + 4 mic mel + 6 GCC), the `acs_aug` input layout,
    from feat_label's foa_dev_norm / foa_dev_label and mic_dev_norm /
    mic_dev_label; FOA's labels."""
    foa_x, y = load_seldnet_data(
        os.path.join(feat_label_root, "foa_dev_norm"),
        os.path.join(feat_label_root, "foa_dev_label"),
        mode=mode, n_freq_bins=n_freq_bins)
    mic_x, _ = load_seldnet_data(
        os.path.join(feat_label_root, "mic_dev_norm"),
        os.path.join(feat_label_root, "mic_dev_label"),
        mode=mode, n_freq_bins=n_freq_bins)
    if len(foa_x) != len(mic_x):
        raise ValueError(
            f"foa ({len(foa_x)}) and mic ({len(mic_x)}) clip counts differ")
    x = [np.concatenate([f, m], axis=-1) for f, m in zip(foa_x, mic_x)]
    return x, y


def read_wav(path: str, pcm: bool = False) -> Tuple[np.ndarray, int]:
    """A 16- or 32-bit PCM wav as ([chan, T], sample rate): float32 scaled
    to [-1, 1) by int / 2^(bits-1), or with `pcm` the on-disk integers."""
    import wave as wave_mod
    with wave_mod.open(path, "rb") as w:
        n, ch, width = w.getnframes(), w.getnchannels(), w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(n)
    if width not in (2, 4):
        raise ValueError(f"{os.path.basename(path)}: unsupported sample "
                         f"width {width}")
    scale = {2: 32768.0, 4: 2147483648.0}[width]
    data = np.frombuffer(raw, {2: np.int16, 4: np.int32}[width])
    if not pcm:
        data = data.astype(np.float32) / scale
    return data.reshape(n, ch).T, sr


def load_wav_clips(wav_dir: str, label_dir: str, mode: str = "train",
                   n_classes: int = 14, max_label_length: int = 600,
                   expected_sr: int = 24000, pcm: bool = False):
    """Raw wavs + label CSVs: returns (wavs [chan, T], labels [600, 4C]).
    Pairs are matched by basename; wavs must be at `expected_sr` (the
    100 ms label-frame geometry assumes 24 kHz; None skips the check).
    `pcm=True` keeps the on-disk integer format (int16/int32); the
    front-end scales it to [-1, 1) with the same int / 2^(bits-1)."""
    from seld_tpu_torch.ops.features import extract_labels

    wav_paths = [p for p in sorted(glob(os.path.join(wav_dir, "*.wav")))
                 if _fold_of(p) in SPLITS[mode]]
    csv_paths = [p for p in sorted(glob(os.path.join(label_dir, "*.csv")))
                 if _fold_of(p) in SPLITS[mode]]
    pairs = _pair_by_basename(wav_paths, csv_paths, "label CSV")

    xs, ys = [], []
    for wav_path, csv_path in pairs:
        wav, sr = read_wav(wav_path, pcm=pcm)
        if expected_sr is not None and sr != expected_sr:
            raise ValueError(
                f"{os.path.basename(wav_path)}: {sr} Hz, expected "
                f"{expected_sr} (the 100 ms label-frame geometry assumes it)")
        xs.append(wav)
        lab = extract_labels(csv_path, n_classes=n_classes)
        if lab.shape[0] < max_label_length:
            lab = np.pad(lab, ((0, max_label_length - lab.shape[0]), (0, 0)))
        else:
            lab = lab[:max_label_length]
        ys.append(lab)
    return xs, ys


def window_clips(features: Sequence, labels: Sequence,
                 label_window_size: int = 60, drop_remainder: bool = True):
    """Clips -> fixed windows.

    features: list of [T_f, F, C] with T_f = multiplier * T_l (numpy, or
              torch for a dtype numpy lacks)
    labels:   list of [T_l, 4C]
    Returns x [N, window*multiplier, F, C], y [N, window, 4C].
    """
    cat = torch.cat if isinstance(features[0], torch.Tensor) \
        else np.concatenate
    feats = cat(list(features), 0)
    labs = np.concatenate(labels, axis=0)
    multiplier = feats.shape[0] // labs.shape[0]
    if feats.shape[0] != multiplier * labs.shape[0]:
        # a non-integer feature/label frame ratio would otherwise silently
        # shift every later clip's windows off its labels
        raise ValueError(
            f"feature frames ({feats.shape[0]}) are not an integer "
            f"multiple of label frames ({labs.shape[0]})")

    n_windows = labs.shape[0] // label_window_size
    if not drop_remainder and labs.shape[0] % label_window_size:
        raise NotImplementedError("partial windows are always dropped")
    labs = labs[: n_windows * label_window_size]
    feats = feats[: n_windows * label_window_size * multiplier]

    y = labs.reshape(n_windows, label_window_size, labs.shape[-1])
    x = feats.reshape(n_windows, label_window_size * multiplier,
                      *feats.shape[1:])
    return x, y


def cast_clips(features: Sequence, feature_dtype) -> list:
    """Cast each clip once, before windowing (window_clips' concatenate is
    the dominant allocation: casting after it would hold the full f32
    tensor and the cast copy at once, 1.5x the split). A torch dtype gives
    torch tensors, a numpy dtype numpy arrays."""
    if isinstance(feature_dtype, torch.dtype):
        return [torch.as_tensor(np.asarray(f)).to(feature_dtype)
                for f in features]
    return [np.asarray(f).astype(feature_dtype) for f in features]


class SeldDataset:
    """In-memory windowed dataset with epoch iteration.

    train=True : sample-shuffled fixed batches, dropping the ragged tail
    train=False: one full clip per batch (windows_per_clip consecutive
                 windows), deterministic order

    Several processes (seld_tpu/data/loader.py:190-226): with
    process_count > 1 each keeps the strided slice x[process_index::
    process_count] of the whole split it was handed, iterates batch_size
    rows of it a step, and draws from RandomState(seed + process_index).
    The step count derives from the global window count floor-divided over
    the processes, so every process runs as many steps (a longer slice
    drops its surplus from the tail of each epoch's permutation). Eval
    batches are whole clips, which a strided slice would break: eval takes
    process_count 1 (every process holds the whole eval split).
    """

    def __init__(self, x, y, batch_size: int, train: bool = True,
                 loop_time: int = 1, windows_per_clip: int = 10,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1):
        if process_count > 1 and not train:
            raise ValueError(
                "process-strided sharding is train-only: eval batches are "
                "whole clips; build the eval dataset with process_count=1 "
                "(every process evaluates the full set)")
        common_n = x.shape[0] // process_count
        if process_count > 1:
            x = x[process_index::process_count]
            y = y[process_index::process_count]
        self.x, self.y = x, y
        self._common_n = common_n
        self.batch_size = batch_size if train else windows_per_clip
        self.train = train
        self.loop_time = loop_time if train else 1
        self._rng = np.random.RandomState(seed + process_index)

    @classmethod
    def from_clips(cls, features, labels, batch_size, train=True,
                   label_window_size=60, loop_time=1, seed=0,
                   process_index=0, process_count=1, feature_dtype=None):
        """feature_dtype: cast the features once at build, clip by clip
        (e.g. torch.bfloat16 for bf16 training). Labels stay f32."""
        total_length = labels[0].shape[0]
        if feature_dtype is not None:
            features = cast_clips(features, feature_dtype)
        x, y = window_clips(features, labels, label_window_size)
        return cls(x, y, batch_size, train=train, loop_time=loop_time,
                   windows_per_clip=total_length // label_window_size,
                   seed=seed, process_index=process_index,
                   process_count=process_count)

    def __len__(self):
        if self.train:
            return (self._common_n * self.loop_time) // self.batch_size
        n = self.x.shape[0] * self.loop_time
        return int(np.ceil(n / self.batch_size))

    def __iter__(self) -> Iterator[Tuple]:
        n = self.x.shape[0]
        if self.train:
            order = np.concatenate(
                [self._rng.permutation(n) for _ in range(self.loop_time)])
            order = order[:len(self) * self.batch_size]
        else:
            order = np.arange(n)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            xi = torch.from_numpy(idx) if isinstance(self.x, torch.Tensor) \
                else idx
            yield self.x[xi], self.y[idx]


class DeviceIterator:
    """Host batches -> the card, one batch ahead.

    Each host batch is copied into pinned memory and from there to the
    device on a side stream, while the compute stream works on the batch
    before it. Before a batch is handed out the compute stream waits on the
    copy's event, and each device tensor is marked as used by the compute
    stream (`record_stream`), so the caching allocator does not hand its
    memory to the next copy while a kernel still reads it. On the CPU the
    host batches pass through in order, as torch tensors.
    """

    _AHEAD = 2    # batches staged: the one handed out and the next

    def __init__(self, iterable, device="cuda"):
        self._iterable = iterable
        self._device = torch.device(device)

    def __iter__(self):
        if self._device.type != "cuda":
            for batch in self._iterable:
                yield tuple(torch.as_tensor(a).to(self._device)
                            for a in batch)
            return
        copy_stream = torch.cuda.Stream(self._device)
        staged = collections.deque()

        def stage(batch):
            pinned = [torch.as_tensor(a).pin_memory() for a in batch]
            with torch.cuda.stream(copy_stream):
                dev = [p.to(self._device, non_blocking=True) for p in pinned]
                done = torch.cuda.Event()
                done.record(copy_stream)
            return dev, done, pinned   # pinned: alive until the copy ends

        source = iter(self._iterable)
        for batch in source:
            staged.append(stage(batch))
            if len(staged) >= self._AHEAD:
                break
        while staged:
            dev, done, _ = staged.popleft()
            compute = torch.cuda.current_stream(self._device)
            compute.wait_event(done)
            for t in dev:
                t.record_stream(compute)
            nxt = next(source, None)
            if nxt is not None:
                staged.append(stage(nxt))
            yield tuple(dev)
