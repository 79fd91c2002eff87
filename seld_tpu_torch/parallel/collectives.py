"""The collectives of the port's data parallelism, and the context that
switches a step's batch-spanning reductions to the global batch.

Only all-reduce (sum) and broadcast are used, so the same code runs on NCCL
across cards, on gloo with CPU tensors and on gloo with CUDA tensors (two
ranks sharing one card): gloo implements only these two for CUDA tensors.
Every rank takes part in every collective (the default group).

`data_parallel(mesh)` marks the span of a step. Inside it, under a
process group (`mesh.distributed`, of any size):
  - `global_sum(t)` all-reduces t; its gradient is all-reduced too, since
    every rank's loss reaches every rank's t (BatchNorm's sums);
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
slots, which leaves every mean of the batch unchanged.
Outside the context, or without a group, every function here is the
identity.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

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


def world() -> int:
    mesh = active()
    return 1 if mesh is None else mesh.world


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks, in place."""
    import torch.distributed as dist
    dist.all_reduce(t)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite `t` with rank `src`'s, in place."""
    import torch.distributed as dist
    dist.broadcast(t, src)
    return t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks of the active step (t itself outside one),
    differentiable."""
    return t if active() is None else _GlobalSum.apply(t)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, rank: int, n: int):
        rows = t.shape[0]
        out = t.new_zeros((n * rows, *t.shape[1:]))
        out[rank * rows:(rank + 1) * rows] = t
        ctx.span = (rank * rows, (rank + 1) * rows)
        return all_reduce_(out)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.span
        return g[lo:hi], None, None


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of t (equal counts), in rank order, on every rank
    of the active step; t itself outside one. Differentiable."""
    mesh = active()
    if mesh is None:
        return t
    return _GatherRows.apply(t, mesh.rank, mesh.world)


def global_rows(rows: int) -> int:
    """The global batch's size for `rows` rows on each rank."""
    return rows * world()


def rows_of(draw: torch.Tensor, dim: int = 0,
            rows: Optional[int] = None) -> torch.Tensor:
    """This rank's slice along `dim` of a draw made for the global batch
    (`global_rows` of it); the draw itself outside a step."""
    mesh = active()
    if mesh is None:
        return draw
    rows = draw.shape[dim] // mesh.world if rows is None else rows
    return draw.narrow(dim, mesh.rank * rows, rows)
