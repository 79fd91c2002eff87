"""Device-resident windowed dataset (seld_tpu/data/device_dataset.py).

The windowed split is staged on the card once (it is reused loop_time x
epochs times). Each epoch's [steps, B] int32 index matrix goes to the card
in one copy, and each step gathers its batch there with the row-gather
kernel (ops/gather.py), reading one row of that matrix: a step makes no
host -> device copy.

One card. The per-epoch shuffle is `SeldDataset`'s exactly (the same
RandomState calls: loop_time permutations of the window count,
concatenated, cut to whole batches), so the batches equal the host
loader's for the same seed. Eval mode gives whole-clip batches in dataset
order. Several cards (the JAX package's sharded staging) are ROADMAP queue
1, item 14.

Each batch is one gather launch that copies x and y with the same ids row
(`LAUNCHES_PER_BATCH`). The index matrix lives in one buffer on the card
for the dataset's life: each epoch writes its ids there in one copy, so
an epoch step captured as a CUDA graph over that buffer
(train/steps.py::make_train_epoch) replays the next epoch with no new
capture.

A rebuilt split (--use_tdm, every tdm_epoch epochs) is a new
`DeviceDataset`: the training CLI drops the old one and the epoch step
captured over it first (`SELDTrainer.release_epoch_program`), so one
train split is staged at a time, and the epoch step is captured anew over
the new one.

Capacity: x at [N, 300, 64, 7] is ~269 KB a window in bf16 (~538 KB f32):
the 4-fold DCASE2021 train split (~4,000 windows) is ~1.1 GB in bf16.
`hbm_bytes()` reports the footprint.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from seld_tpu_torch.data.loader import cast_clips, window_clips
from seld_tpu_torch.ops.gather import gather_batch

LAUNCHES_PER_BATCH = 1


class DeviceDataset:
    """Card-resident windowed split; iteration yields (x, y) batches
    gathered on the card. The trainer sees `device_resident = True` and
    iterates it directly."""

    device_resident = True

    def __init__(self, x, y, batch_size: int, device="cuda", *,
                 train: bool = True, loop_time: int = 1, seed: int = 0):
        if isinstance(device, (list, tuple)):
            if len(device) != 1:
                raise NotImplementedError(
                    "DeviceDataset stages on one card; sharding over several "
                    "is not ported yet (ROADMAP queue 1, item 14)")
            device = device[0]
        self.device = torch.device(device)
        n = x.shape[0]
        if not train:
            if n % batch_size:
                raise ValueError(
                    f"eval windows ({n}) must be a whole number of "
                    f"{batch_size}-window clip batches")
            loop_time = 1
        if batch_size > n:
            raise ValueError(f"batch {batch_size} exceeds the {n} windows — "
                             "lower batch_size or add data")
        x, y = torch.as_tensor(x), torch.as_tensor(y)

        self.batch_size = batch_size
        self.n_windows = n
        self.loop_time = max(int(loop_time), 1)
        self.train = train
        self._rng = np.random.RandomState(seed)
        self._hbm_bytes = (x.numel() * x.element_size()
                           + y.numel() * y.element_size())
        self._x = x.to(self.device).contiguous()
        self._y = y.to(self.device).contiguous()
        self._idx = torch.empty((len(self), batch_size), dtype=torch.int32,
                                device=self.device)

    @classmethod
    def from_clips(cls, features: Sequence, labels: Sequence,
                   batch_size: int, device="cuda", train: bool = True,
                   label_window_size: int = 60, loop_time: int = 1,
                   seed: int = 0, feature_dtype=None):
        total_length = labels[0].shape[0]
        if feature_dtype is not None:
            features = cast_clips(features, feature_dtype)
        x, y = window_clips(features, labels, label_window_size)
        if not train:  # whole-clip batches, as SeldDataset.from_clips
            batch_size = total_length // label_window_size
        return cls(x, y, batch_size, device, train=train,
                   loop_time=loop_time, seed=seed)

    def hbm_bytes(self) -> int:
        return self._hbm_bytes

    @property
    def device_arrays(self):
        """(x_all, y_all) as staged on the card."""
        return self._x, self._y

    def epoch_index_matrix(self) -> torch.Tensor:
        """Write one epoch's [steps, B] int32 index matrix into the
        dataset's buffer on the card (the same tensor every epoch) and
        advance the shuffle."""
        return self._idx.copy_(torch.from_numpy(self._epoch_order()))

    def __len__(self) -> int:
        return (self.n_windows * self.loop_time) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        steps = len(self)
        if not self.train:
            return np.arange(steps * self.batch_size, dtype=np.int32
                             ).reshape(steps, -1)
        order = np.concatenate([self._rng.permutation(self.n_windows)
                                for _ in range(self.loop_time)])
        return np.ascontiguousarray(
            order[:steps * self.batch_size].reshape(steps, -1)
            .astype(np.int32))

    def __iter__(self):
        idx = self.epoch_index_matrix()
        for i in range(len(self)):
            yield gather_batch((self._x, self._y), idx[i])
