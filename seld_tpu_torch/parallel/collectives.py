"""The collectives of the port's data parallelism, and the context that
switches a step's batch-spanning reductions to the global batch.

Only all-reduce (sum) and broadcast are used, so the same code runs on NCCL
across cards, on gloo with CPU tensors and on gloo with CUDA tensors (two
ranks sharing one card): gloo implements only these two for CUDA tensors.
Every rank takes part in every collective (the default group).

`data_parallel(mesh)` marks the span of a step. Inside it, under a
process group (`mesh.distributed`, of any size):
  - `batch_reduce_(t)` all-reduces t in place (BatchNorm's sums, forward
    and backward, inside ops/batch_norm.py's and ops/stem.py's autograd
    Functions);
  - `gather_rows(t)` stacks every rank's rows of t into the global batch
    (an all-reduce of a zero-filled buffer that holds this rank's rows in
    its slot); its gradient is the cotangent of this rank's slot. The
    step's losses read gathered predictions and labels, so every rank
    computes each loss on the global batch with the one-rank formula;
  - `rows_of(draw, dim)` cuts this rank's rows from a random draw made at
    the global batch's size: every rank draws the same numbers from the
    shared generator (dropout masks, the augments' draws), so the masks
    of a row do not depend on the rank count.
Each rank is one slot of the global batch, in rank order; ranks that
replicate (another mesh axis than `data`) hold the same rows in their
slots, which leaves every mean of the batch unchanged. A mesh with a
`model` axis larger than 1 (parallel/mesh.py) runs these over its `data`
sub-group instead: a slot a data index, no row twice.

Tensor parallelism over the `model` axis (parallel/partitioning.py): a
layer whose kernel is this rank's shard computes its shard of the output
from the whole input and puts the output back together over the `model`
sub-group:
  - `enter_shards(x)` is x; its gradient is summed over the model group
    (each rank's shard of the layer sees only its part of dx);
  - `gather_shards(t, dim)` stacks every model rank's shard of t along
    dim; its gradient is this rank's slice;
  - `take_shard(t, dim)` is this rank's slice of a replicated t (a bias
    or scale of sharded channels, heads); its gradient is every rank's
    slice put together, so a replicated leaf's gradient is whole on every
    rank;
  - `reduce_shards(t)` sums partial results over the model group (the
    attention's projection from this rank's heads); its gradient passes.
Downstream of each gather every model rank computes the same activations,
so their cotangents agree and the sums above are exact.

Outside the context, or without a group, every function here is the
identity. An autograd function keeps the group it ran in: the backward may
run on another thread (the autograd engine's, for a card's tensors).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

# the mesh of the step this thread runs now, if under a group (per thread:
# worker threads that share a card, as the NAS search's, run their own
# steps)
_state = threading.local()


@contextlib.contextmanager
def data_parallel(mesh):
    """Run the enclosed step's batch reductions over `mesh`'s ranks (a
    no-op for None or a mesh without a process group)."""
    prev = active()
    if mesh is not None and mesh.distributed:
        _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def active():
    """The mesh of the enclosing `data_parallel` span, or None."""
    return getattr(_state, "mesh", None)


def batch_group():
    """The process group over which the active step's batch is spread
    (None: the default group, also outside a step)."""
    mesh = active()
    return None if mesh is None else mesh.data_group


def _slot() -> Tuple[int, int]:
    """(this rank's slot, the slots) of the active step's global batch."""
    mesh = active()
    if mesh.data_group is None:
        return mesh.rank, mesh.world
    return mesh.data_index, mesh.data_size


def world() -> int:
    """The slots of the active step's global batch (1 outside one)."""
    return 1 if active() is None else _slot()[1]


def primary() -> bool:
    """Whether this rank's rows count once in the active step's batch sums
    (a rank that replicates another's rows adds zeros)."""
    mesh = active()
    return mesh is None or mesh.data_group is not None or mesh.primary


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the ranks of `group` (the default group: all), in
    place."""
    import torch.distributed as dist
    dist.all_reduce(t, group=group)
    return t


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t to reduce in place (NCCL takes contiguous
    tensors only; a gradient may arrive with any strides)."""
    return t.clone(memory_format=torch.contiguous_format)


def batch_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks of the active step's batch, in place."""
    return all_reduce_(t, batch_group())


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite `t` with rank `src`'s, in place."""
    import torch.distributed as dist
    dist.broadcast(t, src)
    return t


def _stack(t: torch.Tensor, dim: int, index: int, n: int, group):
    """Every rank's t (equal shapes) side by side along dim at its index:
    one all-reduce of a zero-filled buffer (gloo has no all-gather for
    CUDA tensors)."""
    shape = list(t.shape)
    shape[dim] *= n
    out = t.new_zeros(shape)
    out.narrow(dim, index * t.shape[dim], t.shape[dim]).copy_(t)
    return all_reduce_(out, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, rank: int, n: int, group):
        rows = t.shape[0]
        ctx.span = (rank * rows, (rank + 1) * rows)
        return _stack(t, 0, rank, n, group)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.span
        return g[lo:hi], None, None, None


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of t (equal counts), in slot order, on every rank
    of the active step; t itself outside one. Differentiable."""
    if active() is None:
        return t
    return _GatherRows.apply(t, *_slot(), batch_group())


def global_rows(rows: int) -> int:
    """The global batch's size for `rows` rows on each rank."""
    return rows * world()


def rows_of(draw: torch.Tensor, dim: int = 0,
            rows: Optional[int] = None) -> torch.Tensor:
    """This rank's slice along `dim` of a draw made for the global batch
    (`global_rows` of it); the draw itself outside a step."""
    if active() is None:
        return draw
    slot, n = _slot()
    rows = draw.shape[dim] // n if rows is None else rows
    return draw.narrow(dim, slot * rows, rows)


# ---------------------------------------------------------------- model axis

def shard_index() -> Tuple[int, int]:
    """(this rank's index, the size) of the active step's model axis; a
    sharded layer outside such a step raises."""
    mesh = active()
    if mesh is None or mesh.model_group is None:
        raise RuntimeError("a layer holds a shard of its kernel outside a "
                           "step over a mesh with a model axis "
                           "(parallel/partitioning.py)")
    return mesh.model_index, mesh.model_size


def _model():
    index, size = shard_index()
    return index, size, active().model_group


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(_fresh(g), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, index, size, group):
        ctx.span = (dim, index * t.shape[dim], t.shape[dim])
        return _stack(t, dim, index, size, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(*ctx.span), None, None, None, None


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, index, size, group):
        n = t.shape[dim] // size
        ctx.dims = (dim, index, size, group)
        return t.narrow(dim, index * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return _stack(g, *ctx.dims), None, None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(_fresh(t), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_shards(x: torch.Tensor) -> torch.Tensor:
    """x, whose gradient is summed over the model group."""
    return _Enter.apply(x, _model()[2])


def gather_shards(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every model rank's shard of t along dim, in rank order;
    differentiable."""
    return _Gather.apply(t, dim % t.dim(), *_model())


def take_shard(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This model rank's slice of a replicated t along dim;
    differentiable."""
    return _Take.apply(t, dim % t.dim(), *_model())


def reduce_shards(t: torch.Tensor) -> torch.Tensor:
    """t summed over the model group; its gradient passes."""
    return _Reduce.apply(t, _model()[2])


def model_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the active step's model group, in place."""
    return all_reduce_(t, _model()[2])
