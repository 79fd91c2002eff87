"""Max and average pooling over channels-last [B, T, F, C]
(seld_tpu/ops/pooling.py, flax.linen.avg_pool).

`max_pool` is `lax.reduce_window(x, -inf, max, ...)`: VALID drops a
trailing remainder that fills no window (300x64 under [5, 2] gives 60x32);
SAME gives ceil(n / stride) outputs and pads with -inf as XLA splits the
pad, the odd cell at the END (F=32 under window 3, stride 2: pad (0, 1),
16 outputs), which F.max_pool2d's symmetric `padding=` cannot express.
Non-overlapping VALID windows (the stems' pools) reduce a window-split
view with `amax`, whose gradient splits evenly over tied maxima; every
other window (XceptionBody's overlapping SAME (1, 3) / (1, 2)) runs
F.max_pool2d, whose gradient goes to one maximum per window, as XLA's
select-and-scatter does.

With SELD_EQ_MAXPOOL_BWD=1 (the JAX package's opt-in knob, read at call
time), a non-overlapping pool whose window divides T and F takes the
`amax` path whatever its padding (SAME pads nothing there): amax's
gradient is the JAX package's equality backward
(seld_tpu/ops/pooling.py:31-99), the cotangent sent to every element equal
to its window's maximum, divided by their count.

`avg_pool` is flax's VALID average pool with strides equal to the window
(the window's mean, a trailing remainder dropped), as DenseNetStage's
strided transition calls it.
"""
from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn.functional as F


def _use_eq_bwd() -> bool:
    """SELD_EQ_MAXPOOL_BWD=1 selects the equality backward."""
    return os.environ.get("SELD_EQ_MAXPOOL_BWD", "0") == "1"


def _eq_bwd_applicable(shape, window, strides) -> bool:
    """A non-overlapping pool whose window divides T and F."""
    return (tuple(window) == tuple(strides) and shape[1] % window[0] == 0
            and shape[2] % window[1] == 0)


def _windows(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """[B, T, F, C] -> [B, T', wt, F', wf, C]: the non-overlapping windows,
    a trailing remainder dropped."""
    b, t, f, c = x.shape
    wt, wf = window
    nt, nf = t // wt, f // wf
    return x[:, :nt * wt, :nf * wf].reshape(b, nt, wt, nf, wf, c)


def max_pool(x: torch.Tensor, window: Sequence[int],
             strides: Sequence[int] = None, padding: str = "VALID"
             ) -> torch.Tensor:
    from seld_tpu_torch.models.layers import same_padding
    window = tuple(window)
    strides = tuple(strides) if strides is not None else window
    padding = padding.upper()
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"unknown padding {padding!r}")
    if (padding == "VALID" and strides == window) or (
            _use_eq_bwd() and _eq_bwd_applicable(x.shape, window, strides)):
        return _windows(x, window).amax(dim=(2, 4))
    t, f = x.shape[1:3]
    x = x.movedim(-1, 1)                       # [B, C, T, F], a view
    if padding == "SAME":
        (t0, t1), (f0, f1) = (same_padding(t, window[0], strides[0]),
                              same_padding(f, window[1], strides[1]))
        if t0 or t1 or f0 or f1:
            x = F.pad(x, (f0, f1, t0, t1), value=float("-inf"))
    return F.max_pool2d(x, window, strides).movedim(1, -1)


def avg_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """VALID average pool over non-overlapping windows (strides = window)."""
    return _windows(x, window).mean(dim=(2, 4))
