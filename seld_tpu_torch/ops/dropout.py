"""Dropout: plain inverted dropout, the identity in eval.

The JAX package draws its own uint16 bits on the TPU (seld_tpu/ops/dropout.py);
random streams cannot match across frameworks, so parity is checked in eval
mode or at rate 0.
"""
from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand_like(x, dtype=torch.float32) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
