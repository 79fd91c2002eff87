"""Batch augmentations on the card (seld_tpu/data/transforms.py).

Each augment is two parts: a draw of its random numbers from a
`torch.Generator` on the batch's device (`draw_*`), and an application
that takes those draws as tensors (`*_apply`). The augment itself,
`fn(generator, x, y) -> (x, y)`, is the two in a row. A test can so hand
the application the numbers the JAX package drew and compare the results
exactly.

  - time/freq masking      `batch_mask`: n_mask random spans per
                           period-frame chunk, as fixed-shape comparisons
  - FOA spatial aug        `foa_intensity_vec_aug`: per-sample axis sign
                           flips + x/z swap, applied consistently to the
                           FOA channels, the IV channels and the cartesian
                           labels
  - random gain            `random_ups_and_downs` on the log-mel channels
  - `compose`

The joint FOA+MIC augments (`acs_aug`, `mic_gcc_perm`) and the CGMM mask
(`cgmm_mask_aug`) come with the joint input (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def _randint(gen: torch.Generator, low: int, high: int, shape,
             device) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=gen, device=device)


# ---------------------------------------------------------------------------
# SpecAugment-style masking
# ---------------------------------------------------------------------------
def _mask_geometry(shape, axis: int, period: int) -> Tuple[int, int]:
    """(mask rows, masked length) of `batch_mask` on a [B, T, F, C] batch."""
    b, t, f, _ = shape
    if t % period != 0:
        raise ValueError("(spec time length / period)'s rest must be 0")
    if axis in (-3, 1):
        return b * (t // period), period
    if axis in (-2, 2):
        return b * (t // period), f
    raise ValueError(f"unsupported mask axis: {axis}")


def draw_mask(gen: torch.Generator, shape, axis: int,
              max_mask_size: Optional[int] = None, period: int = 100,
              n_mask: int = 1, device=None):
    """(sizes, offsets) [rows, n_mask] int64: sizes in [0, max_mask_size),
    offsets in [0, masked length)."""
    rows, total = _mask_geometry(shape, axis, period)
    sizes = _randint(gen, 0, max_mask_size or total, (rows, n_mask), device)
    offsets = _randint(gen, 0, total, (rows, n_mask), device)
    return sizes, offsets


def batch_mask_apply(specs: torch.Tensor, axis: int, sizes: torch.Tensor,
                     offsets: torch.Tensor, period: int = 100
                     ) -> torch.Tensor:
    """Zero each row's spans [offset, offset + size) in `specs` [B, T, F, C];
    time spans lie within each `period`-frame chunk (axis -3), frequency
    spans get a fresh draw per chunk (axis -2). Offsets are wrapped by
    max(total - size, 1), as the JAX package keeps its shapes fixed."""
    b, t, f, c = specs.shape
    _, total = _mask_geometry(specs.shape, axis, period)
    offsets = offsets % torch.clamp_min(total - sizes, 1)
    iota = torch.arange(total, device=specs.device)[None, None, :]
    inside = ((iota >= offsets[..., None])
              & (iota < (offsets + sizes)[..., None]))
    keep = (~inside.any(dim=1)).to(specs.dtype)
    nchunk = t // period
    if axis in (-3, 1):
        keep = keep.reshape(b, nchunk, period, 1, 1)
    else:
        keep = keep.reshape(b, nchunk, 1, f, 1)
    x = specs.reshape(b, nchunk, period, f, c)
    return (x * keep).reshape(b, t, f, c)


def batch_mask(gen: torch.Generator, specs: torch.Tensor, axis: int,
               max_mask_size: Optional[int] = None, period: int = 100,
               n_mask: int = 1) -> torch.Tensor:
    """Batched time/freq masking on [B, T, F, C]."""
    sizes, offsets = draw_mask(gen, specs.shape, axis, max_mask_size,
                               period, n_mask, specs.device)
    return batch_mask_apply(specs, axis, sizes, offsets, period)


# ---------------------------------------------------------------------------
# FOA spatial augmentation
# ---------------------------------------------------------------------------
def draw_foa(gen: torch.Generator, batch: int, device=None):
    """(flip [B, 3] in {0, 1}, swap [B, 1] in {0, 1})."""
    flip = _randint(gen, 0, 2, (batch, 3), device)
    swap = _randint(gen, 0, 2, (batch, 1), device)
    return flip, swap


def _batched_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, ..., k] gathered along the last axis by idx [B, k]."""
    idx = idx.reshape(idx.shape[0], *([1] * (x.dim() - 2)), idx.shape[-1])
    return torch.take_along_dim(x, idx.expand(*x.shape[:-1], idx.shape[-1]),
                                dim=-1)


def foa_intensity_vec_aug_apply(x: torch.Tensor, y: torch.Tensor,
                                flip: torch.Tensor, swap: torch.Tensor):
    """x [B, T, F, 7] (4 mel + 3 IV), y [B, T', 4C] -> the equally
    transformed pair, from the draws of `draw_foa`."""
    b = x.shape[0]
    n_classes = y.shape[-1] // 4
    y4 = y.reshape(*y.shape[:-1], 4, n_classes)
    iv = x[..., -3:]
    cart = y4[..., -3:, :]

    flip = flip.to(x.dtype)
    iv = (1 - 2 * flip.reshape(b, 1, 1, 3)) * iv
    cart = (1 - 2 * flip.to(y.dtype).reshape(b, 1, 3, 1)) * cart

    # swap x/z axes half the time: perm = [0,1,2] or [2,1,0]
    p = 2 * swap.long()
    perm = torch.cat([p, torch.ones_like(p), 2 - p], dim=-1)      # [B, 3]
    correct = torch.arange(3, device=x.device)[None]
    check = (perm != correct).long().sum(-1, keepdim=True)
    feat_perm = (perm + check) % 3

    iv = _batched_take(iv, feat_perm)
    cart = _batched_take(cart.transpose(-1, -2), feat_perm).transpose(-1, -2)
    foa = _batched_take(x[..., 1:4], perm)

    x = torch.cat([x[..., :1], foa, iv], dim=-1)
    y4 = torch.cat([y4[..., :-3, :], cart], dim=-2)
    return x, y4.reshape(y.shape)


def foa_intensity_vec_aug(gen: torch.Generator, x: torch.Tensor,
                          y: torch.Tensor):
    flip, swap = draw_foa(gen, x.shape[0], x.device)
    return foa_intensity_vec_aug_apply(x, y, flip, swap)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------
def split_total_labels_to_sed_doa(x, y):
    n_classes = y.shape[-1] // 4
    return x, (y[..., :n_classes], y[..., n_classes:])


def draw_gain(gen: torch.Generator, device=None) -> torch.Tensor:
    """One N(0, 0.2^2) gain, f32 scalar."""
    return torch.randn((), generator=gen, device=device) * 0.2


def random_ups_and_downs_apply(x: torch.Tensor, y, gain: torch.Tensor):
    """Add `gain` to the log-mel channels (0:4); IV channels are ratios and
    stay untouched."""
    return torch.cat([x[..., :4] + gain, x[..., 4:]], dim=-1), y


def random_ups_and_downs(gen: torch.Generator, x: torch.Tensor, y):
    """Random global gain offset on the log-mel channels (FOA, 7 channels;
    the joint 17-channel input is not ported)."""
    if x.shape[-1] != 7:
        raise NotImplementedError("random_ups_and_downs takes the 7-channel "
                                  "FOA input; the joint input is ROADMAP "
                                  "queue 1, item 8")
    return random_ups_and_downs_apply(x, y, draw_gain(gen, x.device))


def compose(*fns: Callable) -> Callable:
    """Compose generator-driven (x, y) transforms into one augment: each
    draws from the same generator, in order."""
    def augment(gen, x, y):
        for fn in fns:
            x, y = fn(gen, x, y)
        return x, y
    return augment
