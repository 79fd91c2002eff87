"""The training and eval steps (seld_tpu/train/steps.py:22-138, 308-347).

One step: forward in train mode (BatchNorm running statistics update in
place, dropout masks from the state's generator) -> dual loss + L2 kernel
penalty -> gradients -> AGC -> optimizer update of the f32 master
parameters, with the streaming metric updated from the step's predictions.

Mixed precision follows the JAX recipe exactly, not torch.autocast: x is
cast once to `compute_dtype`; every f32 parameter is cast to it inside the
loss (bf16 copies through `torch.func.functional_call`), so gradients flow
back through the cast to the f32 masters; the running statistics stay f32;
predictions are upcast to f32 before the loss.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from seld_tpu_torch.train import metrics as M
from seld_tpu_torch.train.train_state import TrainState


def l2_kernel_penalty(params: Dict[str, torch.Tensor],
                      l2: float) -> torch.Tensor:
    """l2 * sum(w^2) over kernel leaves (keras l1_l2(l2=1e-3) on every
    layer with a kernel_regularizer), skipping every leaf under a module
    named GRU_*/LSTM_* and every recurrent_kernel, as the reference does.
    `params` maps state_dict paths, which equal the flax paths, to f32
    master tensors."""
    device = next(iter(params.values())).device
    if l2 == 0.0:
        return torch.zeros((), device=device)
    squares = []
    for path, p in params.items():
        names = path.split(".")
        if names[-1] == "recurrent_kernel" or any(
                n.startswith(("GRU_", "LSTM_")) for n in names):
            continue
        if "kernel" in names[-1]:
            squares.append(p.square().sum())
    if not squares:
        return torch.zeros((), device=device)
    return l2 * torch.stack(squares).sum()


def make_train_step(*,
                    sed_loss_fn: Callable,
                    doa_loss_fn: Callable,
                    loss_weights: Tuple[float, float] = (1.0, 1000.0),
                    l2: float = 0.0,
                    doa_threshold: float = 20.0,
                    metric_block_size: int = 10,
                    compute_dtype=None):
    """Build a train step.

    sed_loss_fn(y, p) and doa_loss_fn(y, p) return scalars. Step signature:
    (state, metric_state, x, y) -> (state, metric_state, (sed_loss,
    doa_loss)) with y = (sed, doa); the state is updated in place and
    returned.
    """
    w_sed, w_doa = loss_weights

    def cast(p: torch.Tensor) -> torch.Tensor:
        if compute_dtype is not None and p.dtype == torch.float32:
            return p.to(compute_dtype)
        return p

    def step(state: TrainState, metric_state, x, y):
        model = state.model.train()
        sed_y, doa_y = y
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        params = state.params
        with torch.enable_grad():
            sed_p, doa_p = torch.func.functional_call(
                model, {k: cast(p) for k, p in params.items()}, (x,))
            sed_p, doa_p = sed_p.float(), doa_p.float()
            sloss = sed_loss_fn(sed_y, sed_p)
            dloss = doa_loss_fn(doa_y, doa_p)
            loss = (w_sed * sloss + w_doa * dloss
                    + l2_kernel_penalty(params, l2))
            grads = torch.autograd.grad(loss, list(params.values()))
        state.optimizer.step(list(params.values()), grads)
        state.step += 1
        with torch.no_grad():
            metric_state = M.update(metric_state, (sed_y, doa_y),
                                    (sed_p.detach(), doa_p.detach()),
                                    doa_threshold=doa_threshold,
                                    block_size=metric_block_size)
        return state, metric_state, (sloss.detach(), dloss.detach())

    return step


def make_eval_step(*,
                   sed_loss_fn: Callable,
                   doa_loss_fn: Callable,
                   doa_threshold: float = 20.0,
                   metric_block_size: int = 10,
                   return_preds: bool = False,
                   compute_dtype=None):
    """Build an eval step: (state, metric_state, x, y[, n_valid]) ->
    (metric_state, (sed_loss, doa_loss)[, preds]).

    The model runs in eval mode on its f32 parameters; with a
    `compute_dtype`, x is first rounded to it, and the forward then runs in
    f32, as the JAX package's eval step promotes a bf16 input against f32
    parameters. With `n_valid`, predictions and labels are cut to the first
    n_valid rows before the losses and the metric.
    """
    def step(state: TrainState, metric_state, x, y, n_valid=None):
        sed_y, doa_y = y
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        with torch.no_grad():
            sed_p, doa_p = state.model.eval()(x.float())
            sed_p, doa_p = sed_p.float(), doa_p.float()
            if n_valid is not None:
                sed_p, doa_p = sed_p[:n_valid], doa_p[:n_valid]
                sed_y, doa_y = sed_y[:n_valid], doa_y[:n_valid]
            sloss = sed_loss_fn(sed_y, sed_p)
            dloss = doa_loss_fn(doa_y, doa_p)
            metric_state = M.update(metric_state, (sed_y, doa_y),
                                    (sed_p, doa_p),
                                    doa_threshold=doa_threshold,
                                    block_size=metric_block_size)
        if return_preds:
            return metric_state, (sloss, dloss), (sed_p, doa_p)
        return metric_state, (sloss, dloss)

    return step
