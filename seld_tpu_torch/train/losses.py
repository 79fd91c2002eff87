"""Losses (seld_tpu/train/losses.py), on torch tensors.

  - MMSE / MMSE_with_cls_weights: masked MSE over DOA; the mask is the
    active-class indicator round(sum over xyz of y^2), tiled x3 and
    normalised by its sum
  - binary_crossentropy on probabilities, clipped at 1e-7
  - focal_loss
  - sed_loss_with_weights: smoothed targets, elementwise loss * class
    weights, mean (with the reference's focal class-weight quirk)
  - MAE / MSE / MSLE scalar DOA losses and `get_doa_loss`
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# per-class sample counts of the DCASE2021 train split (trainv2.py:25-29)
DCASE2021_TRAIN_SAMPLES = np.asarray(
    [[58193, 32794, 29801, 21478, 14822,
      9174, 66527, 6740, 9342, 6498,
      22218, 49758]], dtype=np.float32)


def class_weights_from_samples(samples, device=None) -> torch.Tensor:
    """mean(counts) / counts  (trainv2.py:30), f32."""
    samples = torch.as_tensor(np.asarray(samples, np.float32), device=device)
    return samples.mean() / samples


def _doa_mask(y_true: torch.Tensor) -> torch.Tensor:
    """[..., 3C] -> activity mask [..., C]: round(sum over xyz of y^2)."""
    xyz = y_true.reshape(*y_true.shape[:-1], 3, -1)
    return torch.round((xyz ** 2).sum(dim=-2))


def MMSE(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Masked MSE over active-class DOA components."""
    return MMSE_with_cls_weights(y_true, y_pred)


def MMSE_with_cls_weights(y_true: torch.Tensor, y_pred: torch.Tensor,
                          cls_weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    y_true = y_true.to(y_pred.dtype)
    mask = _doa_mask(y_true)
    if cls_weights is not None:
        mask = mask * cls_weights
    mask = torch.cat([mask] * 3, dim=-1)
    return ((y_true - y_pred).square() * mask).sum() / mask.sum()


def binary_crossentropy(y_true: torch.Tensor, y_pred: torch.Tensor,
                        eps: float = 1e-7) -> torch.Tensor:
    """Elementwise BCE on probabilities (tf.keras.backend parity)."""
    y_pred = torch.clamp(y_pred, eps, 1.0 - eps)
    return -(y_true * torch.log(y_pred)
             + (1.0 - y_true) * torch.log(1.0 - y_pred))


def focal_loss(y_true: torch.Tensor, y_pred: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0,
               reduce: bool = True) -> torch.Tensor:
    eps = 1e-7
    y_pred = torch.clamp(y_pred, eps, 1.0 - eps)
    focal = (- y_true * alpha * (1.0 - y_pred) ** gamma * torch.log(y_pred)
             - (1.0 - y_true) * alpha * y_pred ** gamma
             * torch.log(1.0 - y_pred))
    return focal.mean() if reduce else focal


def sed_loss_with_weights(y_true: torch.Tensor, y_pred: torch.Tensor,
                          cls_weights: Optional[torch.Tensor] = None,
                          label_smoothing: float = 0.0,
                          kind: str = "BCE",
                          focal_alpha: float = 0.25,
                          focal_gamma: float = 2.0) -> torch.Tensor:
    """trainv2-style SED loss: smooth targets, elementwise loss * weights,
    mean."""
    if label_smoothing > 0:
        y_true = y_true * (1.0 - label_smoothing) + 0.5 * label_smoothing
    if kind == "BCE":
        per = binary_crossentropy(y_true, y_pred)
    elif kind == "FOCAL":
        per = focal_loss(y_true, y_pred, focal_alpha, focal_gamma,
                         reduce=False)
    else:
        raise ValueError(f"unknown sed loss: {kind!r}")
    if cls_weights is not None:
        if kind == "FOCAL":
            # reference quirk (trainv2.py:41): focal_loss already reduces
            # to a scalar there, so reduce_mean(focal * cls_weights) is
            # mean(focal) * mean(cls_weights), a constant rescale
            return per.mean() * cls_weights.mean()
        per = per * cls_weights
    return per.mean()


def MAE(y_true, y_pred):
    return (y_true - y_pred).abs().mean()


def MSE(y_true, y_pred):
    return (y_true - y_pred).square().mean()


def MSLE(y_true, y_pred, eps: float = 1e-7):
    # keras MSLE clamps with epsilon BEFORE log1p: cartesian DOA targets
    # are negative half the time (log1p(-1) = -inf without the clamp)
    return (torch.log1p(torch.clamp_min(y_true, eps))
            - torch.log1p(torch.clamp_min(y_pred, eps))).square().mean()


DOA_LOSSES = {"MAE": MAE, "MSE": MSE, "MSLE": MSLE, "MMSE": MMSE}


def get_doa_loss(name: str):
    if name not in DOA_LOSSES:
        raise ValueError(f"unknown doa loss: {name!r}; known "
                         f"{sorted(DOA_LOSSES)}")
    return DOA_LOSSES[name]
