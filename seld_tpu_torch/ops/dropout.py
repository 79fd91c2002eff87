"""Dropout: plain inverted dropout, the identity in eval.

The mask is drawn with `torch.rand(..., generator=)` from an explicit
`torch.Generator` on the tensor's device: training hands every module that
drops the one generator of its `TrainState` (`set_dropout_generator`), so
a seed fixes the masks. The JAX package draws its own uint16 bits on the
TPU (seld_tpu/ops/dropout.py); random streams cannot match across
frameworks, so parity is checked in eval mode or at rate 0. Inside a
data-parallel step (parallel/collectives.py) a mask is drawn at the global
batch's size and each rank keeps its rows, so a row's mask does not depend
on the rank count.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from seld_tpu_torch.parallel import collectives


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None,
            shard_dim: Optional[int] = None) -> torch.Tensor:
    """Zero each element with probability `rate` and scale the rest by
    1 / (1 - rate). `generator` must live on x's device; None draws from
    torch's default generator of that device. `shard_dim`: x holds this
    rank's shard along it (tensor parallelism): the mask is drawn whole and
    this rank's shard kept."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    shape = [collectives.global_rows(x.shape[0]), *x.shape[1:]]
    if shard_dim is not None:
        index, size = collectives.shard_index()
        shape[shard_dim] *= size
    u = collectives.rows_of(torch.rand(
        shape, generator=generator, device=x.device, dtype=torch.float32))
    if shard_dim is not None:
        n = x.shape[shard_dim]
        u = u.narrow(shard_dim, index * n, n)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def keep_mask(shape, keep: float, generator: Optional[torch.Generator],
              device, dtype: torch.dtype, batch_dim: int = 0
              ) -> torch.Tensor:
    """A Bernoulli(keep) mask of `shape` scaled by 1 / keep, in `dtype`:
    the per-gate masks of the recurrent layers (Keras implementation=1),
    drawn from `generator` on `device`; `shape[batch_dim]` is the batch."""
    shape = list(shape)
    rows = shape[batch_dim]
    shape[batch_dim] = collectives.global_rows(rows)
    u = collectives.rows_of(
        torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32), batch_dim, rows)
    return (u < keep).to(dtype) / keep


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every submodule that draws dropout masks (it has a
    `dropout_generator` attribute) at `generator`."""
    for m in model.modules():
        if hasattr(m, "dropout_generator"):
            m.dropout_generator = generator
