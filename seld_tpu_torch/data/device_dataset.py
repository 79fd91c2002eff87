"""Device-resident windowed dataset (seld_tpu/data/device_dataset.py).

The windowed split is staged on the card once (it is reused loop_time x
epochs times). Each epoch's [steps, B] int32 index matrix goes to the card
in one copy, and each step gathers its batch there with the row-gather
kernel (ops/gather.py), reading one row of that matrix: a step makes no
host -> device copy.

The per-epoch shuffle is `SeldDataset`'s exactly on one shard (the same
RandomState calls: loop_time permutations of the window count,
concatenated, cut to whole batches), so the batches equal the host
loader's for the same seed. Eval mode gives whole-clip batches in dataset
order.

Sharded (`mesh=` of parallel/mesh.py, the JAX package's staging over the
mesh's data axis): every rank is handed the whole split, as every rank
builds it, and stages only its shard, the `data_index`-th of equal
contiguous slices (a tail that does not divide is trimmed), on its own
card. Each rank draws every shard's permutation from the shared
RandomState and keeps its own, so the global batch a step is the JAX
package's, and a rank samples only its shard. Eval rows are staged
pre-permuted shard-major (seld_tpu/data/device_dataset.py:92-109), so the
global eval batches come out in dataset order on any rank count; each
rank yields its rows of them.

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
from seld_tpu_torch.parallel.mesh import batch_shard_count
from seld_tpu_torch.utils.profiling import span

LAUNCHES_PER_BATCH = 1


class DeviceDataset:
    """Card-resident windowed split; iteration yields (x, y) batches
    gathered on the card. The trainer sees `device_resident = True` and
    iterates it directly."""

    device_resident = True

    def __init__(self, x, y, batch_size: int, device="cuda", *,
                 train: bool = True, loop_time: int = 1, seed: int = 0,
                 mesh=None):
        """x, y: the whole split; batch_size: the global batch."""
        self.device = torch.device(device)
        n_shards = batch_shard_count(mesh)
        n = x.shape[0]
        if batch_size % n_shards:
            raise ValueError(f"batch_size {batch_size} must divide over the "
                             f"{n_shards}-way data axis")
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        local_b = batch_size // n_shards
        if not train:
            if n % batch_size:
                raise ValueError(
                    f"eval windows ({n}) must be a whole number of "
                    f"{batch_size}-window clip batches")
            loop_time = 1
            if n_shards > 1:
                # shard s holds the rows of positions [s local_b, (s + 1)
                # local_b) of every batch: gathered shard-major, each
                # global batch is in dataset order
                perm = torch.from_numpy(
                    np.arange(n).reshape(-1, n_shards, local_b)
                    .transpose(1, 0, 2).reshape(-1))
                x, y = x[perm], y[perm]
        n -= n % n_shards              # equal shards: the tail is trimmed
        shard_len = n // n_shards
        if local_b > shard_len:
            raise ValueError(f"batch {local_b} exceeds the {shard_len} "
                             "windows — lower batch_size or add data")
        first = (0 if mesh is None else mesh.data_index) * shard_len

        self.batch_size = batch_size
        self.local_batch = local_b
        self.n_windows = n             # over all shards, after the trim
        self.shard_len = shard_len
        self.n_shards = n_shards
        self.loop_time = max(int(loop_time), 1)
        self.train = train
        self._rng = np.random.RandomState(seed)
        self._hbm_bytes = n * (x[0].numel() * x.element_size()
                               + y[0].numel() * y.element_size())
        self._x = x[first:first + shard_len].to(self.device).contiguous()
        self._y = y[first:first + shard_len].to(self.device).contiguous()
        self._shard = 0 if mesh is None else mesh.data_index
        self._idx = torch.empty((len(self), local_b), dtype=torch.int32,
                                device=self.device)

    @classmethod
    def from_clips(cls, features: Sequence, labels: Sequence,
                   batch_size: int, device="cuda", train: bool = True,
                   label_window_size: int = 60, loop_time: int = 1,
                   seed: int = 0, feature_dtype=None, mesh=None):
        total_length = labels[0].shape[0]
        if feature_dtype is not None:
            features = cast_clips(features, feature_dtype)
        x, y = window_clips(features, labels, label_window_size)
        if not train:  # whole-clip batches, as SeldDataset.from_clips
            batch_size = total_length // label_window_size
        return cls(x, y, batch_size, device, train=train,
                   loop_time=loop_time, seed=seed, mesh=mesh)

    def hbm_bytes(self) -> int:
        """Bytes of the split over all its shards (this rank stages
        1 / n_shards of them)."""
        return self._hbm_bytes

    @property
    def device_arrays(self):
        """(x_all, y_all): this rank's shard as staged on its card."""
        return self._x, self._y

    def epoch_index_matrix(self) -> torch.Tensor:
        """Write one epoch's [steps, B / n_shards] int32 matrix of this
        shard's rows into the dataset's buffer on the card (the same tensor
        every epoch) and advance the shuffle (the span
        `seld.feed.epoch_index`: what an epoch waits on its feed)."""
        with span("seld.feed.epoch_index"):
            return self._idx.copy_(torch.from_numpy(self._epoch_order()))

    def __len__(self) -> int:
        return (self.shard_len * self.loop_time) // self.local_batch

    def _epoch_order(self) -> np.ndarray:
        steps = len(self)
        if not self.train:
            return np.arange(steps * self.local_batch, dtype=np.int32
                             ).reshape(steps, -1)
        # every shard's permutations in shard order, as the JAX package
        # draws them; this rank keeps its own
        orders = [np.concatenate([self._rng.permutation(self.shard_len)
                                  for _ in range(self.loop_time)])
                  for _ in range(self.n_shards)]
        return np.ascontiguousarray(
            orders[self._shard][:steps * self.local_batch]
            .reshape(steps, -1).astype(np.int32))

    def __iter__(self):
        idx = self.epoch_index_matrix()
        for i in range(len(self)):
            yield gather_batch((self._x, self._y), idx[i])
