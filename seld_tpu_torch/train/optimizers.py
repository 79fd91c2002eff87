"""Optimizers and gradient tools (seld_tpu/train/optimizers.py).

  - AdaBelief: the reference's TF2 update rule (utils.py:99-247):
      m_t = b1 m + (1-b1) g;  v_t = b2 v + (1-b2)(g - m_t)^2
      step = lr * sqrt(1 - b2^t)/(1 - b1^t) * m_t / (sqrt(v_t) + eps)
    eps = 1e-7 outside the sqrt; amsgrad (a running max of v) optional.
  - Adam: optax's scale_by_adam with Keras' eps 1e-7.
  - adaptive_clip_grad: NFNet-style AGC (utils.py:67-96) with the
    reference's unit-wise norms: scalars/vectors -> global norm; 2D/3D ->
    axis 0; 4D conv HWIO -> axes (0, 1, 2). The port keeps flax layouts
    (HWIO, [D, I, 3U]), so the axes carry over unchanged.

An optimizer updates a list of f32 master parameters in place:
`opt.step(params, grads)`, with AGC (`agc_clip`) applied first to the raw
gradients, as `adabelief(..., agc_clip=)` chains it.

The step count and the learning rate are 0-dim f32 tensors on the
parameters' device, and the bias corrections are computed from the count
there, in f32, as the JAX package computes them inside its compiled step.
A step so reads no value from the host, and a CUDA graph that captured it
(train/graphs.py) advances the count on every replay and sees a new
learning rate: `opt.lr = v` writes into the tensor in place. `opt.lr`
reads back the value last set (a Python float, as it was given) and
`opt.count` the count as an int.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def _unit_dims(ndim: int) -> Tuple[int, ...]:
    """The dims a unit-wise norm sums over."""
    if ndim <= 1:
        return tuple(range(ndim))
    if ndim in (2, 3):
        return (0,)
    if ndim == 4:
        return (0, 1, 2)
    raise ValueError(f"Got a parameter with shape not in [1, 2, 3, 4]: "
                     f"{ndim} dims")


def unitwise_norm(x: torch.Tensor,
                  shard_dim: Optional[int] = None) -> torch.Tensor:
    """The unit-wise norm of x; where x is this rank's shard along
    `shard_dim` (tensor parallelism) and the norm sums over that dim, the
    squared sums are summed over the model group first."""
    dims = _unit_dims(x.dim())
    if x.dim() <= 1:
        sq = x.square().sum()
    else:
        sq = x.square().sum(dim=dims, keepdim=True)
    if shard_dim is not None and shard_dim in dims:
        from seld_tpu_torch.parallel import collectives
        sq = collectives.model_sum_(sq)
    return sq.sqrt()


def adaptive_clip_grad(params: Sequence[torch.Tensor],
                       grads: Sequence[torch.Tensor],
                       clip_factor: float = 0.01, eps: float = 1e-3,
                       shard_dims: Optional[Sequence[Optional[int]]] = None
                       ) -> List[torch.Tensor]:
    """AGC over matching parameter/gradient lists; `shard_dims`: the dim
    each parameter is sharded along over the model axis, or None."""
    out = []
    if shard_dims is None:
        shard_dims = [None] * len(params)
    for p, g, d in zip(params, grads, shard_dims):
        max_norm = unitwise_norm(p, d).clamp_min(eps) * clip_factor
        g_norm = unitwise_norm(g, d)
        clipped = g * (max_norm / g_norm.clamp_min(1e-6))
        out.append(torch.where(g_norm < max_norm, g, clipped))
    return out


class _Optimizer:
    def __init__(self, params: Sequence[torch.Tensor], learning_rate: float,
                 agc_clip: Optional[float]):
        params = list(params)
        device = params[0].device if params else torch.device("cpu")
        self.agc_clip = agc_clip
        self._lr = torch.zeros((), dtype=torch.float32, device=device)
        self._count = torch.zeros((), dtype=torch.float32, device=device)
        self.lr = learning_rate
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @property
    def lr(self) -> float:
        return self._lr_value

    @lr.setter
    def lr(self, value: float) -> None:
        self._lr_value = float(value)
        self._lr.fill_(self._lr_value)

    @property
    def count(self) -> int:
        """Updates taken so far (reads the device tensor)."""
        return int(self._count.item())

    @count.setter
    def count(self, value: int) -> None:
        self._count.fill_(int(value))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor],
             shard_dims: Optional[Sequence[Optional[int]]] = None) -> None:
        """One update of `params` in place from `grads`; `shard_dims` as
        `adaptive_clip_grad` takes them."""
        grads = list(grads)
        if self.agc_clip is not None:
            grads = adaptive_clip_grad(params, grads, self.agc_clip,
                                       shard_dims=shard_dims)
        self._count.add_(1)
        scaled = self._scale(grads)
        # params + (-lr) * update, as optax's scale_by_learning_rate and
        # apply_updates compose it (lr * u negated is exact)
        torch._foreach_sub_(list(params), torch._foreach_mul(scaled,
                                                             self._lr))


class AdaBelief(_Optimizer):
    """Reference AdaBelief (scale_by_adabelief_ref + learning rate)."""

    def __init__(self, params, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-7, amsgrad: bool = False,
                 agc_clip: Optional[float] = None):
        super().__init__(params, learning_rate, agc_clip)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.vhat = [torch.zeros_like(p) for p in params] if amsgrad \
            else None

    def _scale(self, grads):
        b1, b2, t = self.b1, self.b2, self._count
        torch._foreach_mul_(self.m, b1)
        torch._foreach_add_(self.m, grads, alpha=1 - b1)
        diff = torch._foreach_sub(grads, self.m)
        torch._foreach_mul_(self.v, b2)
        torch._foreach_addcmul_(self.v, diff, diff, value=1 - b2)
        denom = self.v
        if self.vhat is not None:
            torch._foreach_maximum_(self.vhat, self.v)
            denom = self.vhat
        # bias corrections in f32 on the device, as the JAX package
        # computes them
        correction = torch.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        den = torch._foreach_sqrt(denom)
        torch._foreach_add_(den, self.eps)
        return torch._foreach_div(torch._foreach_mul(self.m, correction),
                                  den)


class Adam(_Optimizer):
    """optax.scale_by_adam(b1, b2, eps) + learning rate, Keras' eps 1e-7."""

    def __init__(self, params, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-7,
                 agc_clip: Optional[float] = None):
        super().__init__(params, learning_rate, agc_clip)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _scale(self, grads):
        b1, b2, t = self.b1, self.b2, self._count
        torch._foreach_mul_(self.m, b1)
        torch._foreach_add_(self.m, grads, alpha=1 - b1)
        torch._foreach_mul_(self.v, b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1 - b2)
        m_hat = torch._foreach_div(self.m, 1 - b1 ** t)
        den = torch._foreach_sqrt(torch._foreach_div(self.v, 1 - b2 ** t))
        torch._foreach_add_(den, self.eps)
        return torch._foreach_div(m_hat, den)


def adabelief(params, learning_rate: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-7, amsgrad: bool = False,
              agc_clip: Optional[float] = None) -> AdaBelief:
    return AdaBelief(params, learning_rate, b1, b2, eps, amsgrad, agc_clip)


def adam(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-7, agc_clip: Optional[float] = None) -> Adam:
    return Adam(params, learning_rate, b1, b2, eps, agc_clip)
