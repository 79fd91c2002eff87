"""Training state (seld_tpu/train/train_state.py).

`TrainState` holds what one training run carries from step to step: the
step count, the model (its parameters are the f32 masters, its buffers the
BatchNorm running statistics), the optimizer with its moments, and the one
`torch.Generator` that draws every dropout mask — on the model's device, so
a seed fixes the masks on the card as on the CPU. `SWAState` keeps the
running average of parameters AND batch statistics (the reference averages
model.get_weights(), which includes BatchNorm's moving statistics,
swa.py:14-32).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from seld_tpu_torch.ops.dropout import set_dropout_generator


class TrainState:
    def __init__(self, model: nn.Module, optimizer, seed: int = 0):
        """`optimizer` must have been built over
        `list(model.parameters())`, in that order."""
        self.step = 0
        self.model = model
        self.optimizer = optimizer
        device = next(model.parameters()).device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        set_dropout_generator(model, self.generator)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())

    def get_lr(self) -> float:
        return self.optimizer.lr

    def set_lr(self, lr: float) -> "TrainState":
        self.optimizer.lr = float(lr)
        return self


class SWAState:
    """Running average of parameters and batch statistics, captured every
    `freq` epochs past `start_epoch`."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 batch_stats: Optional[Dict[str, torch.Tensor]] = None):
        self.count = 0
        self.avg_params = {k: torch.zeros_like(v) for k, v in params.items()}
        self.avg_batch_stats = (
            {k: torch.zeros_like(v) for k, v in batch_stats.items()}
            if batch_stats is not None else None)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               batch_stats: Optional[Dict[str, torch.Tensor]] = None
               ) -> "SWAState":
        self.count += 1

        def avg_into(avg, new):
            for k, a in avg.items():
                a.add_((new[k] - a) / self.count)

        avg_into(self.avg_params, params)
        if self.avg_batch_stats is not None and batch_stats is not None:
            avg_into(self.avg_batch_stats, batch_stats)
        return self

    def should_update(self, epoch: int, start_epoch: int, freq: int) -> bool:
        return epoch >= start_epoch and (epoch - start_epoch) % freq == 0

    @property
    def available(self) -> bool:
        return self.count > 0
