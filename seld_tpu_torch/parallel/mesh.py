"""Data-parallel layout over the ranks of a process group
(seld_tpu/parallel/mesh.py).

The JAX package runs data parallelism through GSPMD: one process holds
every chip, parameters are replicated and batches sharded over the mesh's
`data` axis. Here each card is a process (a rank of a
`torch.distributed` group), so a mesh is a small record of where this
rank stands: `make_mesh(spec)` reads the group (world size 1 and no group
when none is initialised), lays the ranks out in the spec's axes in the
order `np.reshape` gives JAX's device array, and keeps this rank's index
on the `data` axis. Batches are sharded over `data` alone, as the JAX
trainer shards them; ranks that differ only on another axis take the same
rows (that axis replicates).

Tensor parallelism over a `model` axis (parallel/partitioning.py) needs
two families of process sub-groups, which `make_groups` makes (every rank
calls it, as `shard_tree` does): the `data` group of a rank holds the
ranks that differ from it only on the data axis (its batch collectives run
there), and the `model` group the ranks that differ only on the model axis
(the activation collectives of sharded layers). A mesh without them keeps
every batch collective on the whole group, where ranks that replicate hold
the same rows.

`shard_batch` takes this rank's rows of a global batch, `replicate`
broadcasts tensors from rank 0. Without a process group (world size 1)
both are the identity and nothing is communicated: the single-card path
is unchanged. A group of one rank runs its collectives (a check of the
backend, as the NCCL group of one in chip_smoke's [dp]).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from seld_tpu_torch.parallel import collectives


def visible_devices() -> int:
    """What `data:-1` covers when no count is given: the world size of an
    initialised group, else the visible cards (at least 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max(torch.cuda.device_count(), 1)


def parse_mesh_spec(spec: str, n_devices: Optional[int] = None
                    ) -> Dict[str, int]:
    """'data:-1' or 'data:4,model:2' -> {axis: size}; -1 = all remaining."""
    if n_devices is None:
        n_devices = visible_devices()
    axes: Dict[str, int] = {}
    wildcard = None
    for part in spec.split(","):
        name, _, size = part.strip().partition(":")
        size = int(size) if size else -1
        if size == -1:
            if wildcard is not None:
                raise ValueError(f"only one -1 axis allowed in {spec!r}")
            wildcard = name
            axes[name] = -1
        else:
            axes[name] = size
    fixed = int(np.prod([s for s in axes.values() if s != -1]))
    if wildcard is not None:
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes {axes}")
        axes[wildcard] = n_devices // fixed
    elif fixed != n_devices:
        raise ValueError(f"mesh {axes} does not cover {n_devices} devices")
    return axes


@dataclass(frozen=True)
class Mesh:
    """Where this rank stands: `world` ranks laid out in `axes`; this rank
    is `rank`, at `data_index` of the `data` axis's `data_size` shards,
    and computes on `device`; `distributed`: a process group is
    initialised, so the steps' batch reductions go through its
    collectives (at one rank too); `primary`: the first of the ranks that
    hold its rows (index 0 on every other axis), whose rows a count (the
    metric) takes once; `model_size` and `model_index`: the `model` axis
    and this rank's place on it; `data_group` and `model_group`: this
    rank's sub-groups along each axis, once `make_groups` has made them
    (None before)."""
    axes: Dict[str, int]
    world: int
    rank: int
    data_size: int
    data_index: int
    device: torch.device
    distributed: bool = False
    primary: bool = True
    model_size: int = 1
    model_index: int = 0
    groups: Dict[str, Any] = field(default_factory=dict, compare=False,
                                   repr=False)

    @property
    def data_group(self):
        return self.groups.get("data")

    @property
    def model_group(self):
        return self.groups.get("model")

    def make_groups(self) -> "Mesh":
        """Make this rank's data and model sub-groups (a collective call:
        every rank of the group makes every sub-group, in the same order);
        nothing without a process group or a model axis. Returns the
        mesh."""
        if self.distributed and self.model_size > 1 and not self.groups:
            import torch.distributed as dist
            for axis in ("data", "model"):
                self.groups[axis], _ = dist.new_subgroups_by_enumeration(
                    _lines_along(self.axes, axis))
        return self


def _lines_along(axes: Dict[str, int], axis: str) -> List[List[int]]:
    """The rank lists that differ only on `axis` (one a line of the rank
    grid; each rank alone where the mesh has no such axis)."""
    sizes = tuple(axes.values())
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    if axis not in axes:
        return [[int(r)] for r in grid.ravel()]
    k = tuple(axes).index(axis)
    return [[int(r) for r in line] for line in
            np.moveaxis(grid, k, -1).reshape(-1, sizes[k])]


def make_mesh(spec: str = "data:-1", device=None) -> Mesh:
    """The mesh of the current process group (world 1 without one) in the
    axes of `spec`, which must cover the group's ranks exactly."""
    import torch.distributed as dist
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    axes = parse_mesh_spec(spec, world)
    names = tuple(axes)
    position = np.unravel_index(rank, tuple(axes[n] for n in names))
    data = names.index("data") if "data" in names else None
    model = names.index("model") if "model" in names else None
    return Mesh(axes=axes, world=world, rank=rank,
                data_size=axes["data"] if data is not None else 1,
                data_index=int(position[data]) if data is not None else 0,
                device=torch.device(device if device is not None else
                                    "cuda"),
                distributed=grouped,
                primary=all(int(p) == 0 for i, p in enumerate(position)
                            if i != data),
                model_size=axes["model"] if model is not None else 1,
                model_index=int(position[model]) if model is not None
                else 0)


def batch_shard_count(mesh: Optional[Mesh]) -> int:
    """Number of distinct shards along the batch dim: the `data` axis's
    size (a data:4,model:2 mesh shards batches 4 ways over 8 ranks)."""
    return 1 if mesh is None else mesh.data_size


def shard_batch(batch, mesh: Optional[Mesh]):
    """This rank's rows of every leaf of a global batch (a tensor, array
    or tuple of them): the `data_index`-th of `data_size` equal slices of
    the leading dim."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    n = batch_shard_count(mesh)
    if n == 1:
        return batch
    if batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} rows does not shard "
                         f"evenly over the {n}-way data axis")
    rows = batch.shape[0] // n
    return batch[mesh.data_index * rows:(mesh.data_index + 1) * rows]


@torch.no_grad()
def replicate(tensors, mesh: Optional[Mesh]):
    """Broadcast every tensor (a module's parameters and buffers, a dict's
    or a sequence's values) from rank 0, in place; returns `tensors`."""
    if mesh is None or not mesh.distributed:
        return tensors
    if isinstance(tensors, torch.nn.Module):
        leaves = list(tensors.parameters()) + list(tensors.buffers())
    elif isinstance(tensors, dict):
        leaves = list(tensors.values())
    else:
        leaves = list(tensors)
    for t in leaves:
        collectives.broadcast_(t)
    return tensors
