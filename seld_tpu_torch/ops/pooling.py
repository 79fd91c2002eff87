"""Max pooling over channels-last [B, T, F, C] (seld_tpu/ops/pooling.py).

Forward only, VALID and non-overlapping (window == strides), as the
conv_temporal stem uses it: a trailing remainder that fills no window is
dropped, so 300x64 under [5, 2] gives 60x32.
"""
from __future__ import annotations

from typing import Sequence

import torch


def max_pool(x: torch.Tensor, window: Sequence[int],
             strides: Sequence[int] = None, padding: str = "VALID"
             ) -> torch.Tensor:
    window = tuple(window)
    strides = tuple(strides) if strides is not None else window
    if strides != window or padding.upper() != "VALID":
        raise NotImplementedError(
            "only VALID non-overlapping max pooling is ported")
    b, t, f, c = x.shape
    wt, wf = window
    nt, nf = t // wt, f // wf
    x = x[:, :nt * wt, :nf * wf].reshape(b, nt, wt, nf, wf, c)
    return x.amax(dim=(2, 4))
