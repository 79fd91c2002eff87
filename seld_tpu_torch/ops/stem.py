"""Fused stem: conv2d + train-mode BatchNorm + ReLU + non-overlapping max
pool, with a hand-scheduled backward (seld_tpu/ops/stem.py).

The forward is the JAX `_forward` formula for formula: the SAME conv, then
the bias added in the storage dtype; f32 batch statistics with the biased
E[y^2] - E[y]^2, from [sum y, sum y^2] (`ops.batch_norm.batch_norm_stats`,
one read of y on the card); scale/shift cast to y's dtype
(`stem_bwd.bn_affine`); bno = y * scale + shift; the pre-ReLU pool max m_bno is saved; pooled =
relu(m_bno).

The backward needs one full-resolution pass beyond the conv's own
gradients:
  - dgamma/dbeta come from the saved pool max on pooled-size tensors:
      dbeta  = sum(dpooled * (m > 0))
      dgamma = sum(dpooled * (m > 0) * (m - beta) / gamma)
    (gamma == 0 contributes 0, as in the JAX package);
  - dy and dbias come from `stem_bwd.stem_dy` — the hand-written CUDA
    kernel on the card, its plain version on the CPU — which writes dy over
    y, since y is dead after it;
  - the conv's weight and input gradients stay library calls
    (torch.nn.grad), as the JAX package leaves them to XLA. The input
    gradient is computed only when the input needs one.

Inside a data-parallel step (parallel/collectives.py) the statistics are
the global batch's: the forward all-reduces [sum y, sum y^2], and the
backward all-reduces [dgamma, dbeta] before it forms stem_dy's params6
with the global count, so stem_dy computes this rank's dy from global
terms. The returned dgamma, dbeta and dbias stay this rank's: the step's
gradient all-reduce sums each of them once (the JAX package's one psum of
dbias, seld_tpu/ops/pallas/stem_bwd.py:152-155). Under tensor
parallelism (parallel/partitioning.py) a rank holds half the filters:
these sums run over the data sub-group, and each rank's statistics,
stem_dy and gradients are its own channels'.

Pool ties split the window's cotangent equally among the tied maxima
(count-normalised), instead of the first-match routing of a composed max
pool; the routed total per window is the same.

Layout: the conv takes [B, C, T, F] views of the channels-last features,
so PyTorch keeps its output y channels-last in memory, and y stays in the
conv's own buffer; the public tensors are [B, T, F, C] views, the JAX
package's layout.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from seld_tpu_torch.ops.batch_norm import batch_norm_stats
from seld_tpu_torch.ops.stem_bwd import bn_affine, stem_dy
from seld_tpu_torch.parallel import collectives


def _pad_same(x_cf: torch.Tensor, ksize: Sequence[int]):
    """XLA "SAME" zero padding of a channels-first [B, C, T, F] input for a
    unit-stride conv; returns (padded, ((t0, t1), (f0, f1)))."""
    from seld_tpu_torch.models.layers import same_padding
    pt = same_padding(x_cf.shape[2], ksize[0], 1)
    pf = same_padding(x_cf.shape[3], ksize[1], 1)
    return F.pad(x_cf, (*pf, *pt)), (pt, pf)


class _ConvBNReLUPool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, bias, gamma, beta, pool, eps):
        pt, pf = pool
        x_pad, pads = _pad_same(x.movedim(-1, 1), kernel.shape[:2])
        w = kernel.permute(3, 2, 0, 1)                        # HWIO -> OIHW
        y = F.conv2d(x_pad, w) + bias.to(x.dtype)[:, None, None]
        b, c, t, f = y.shape
        # [sum y, sum y^2] in one read of y (batch_norm.cu's pass 1), over
        # the global batch under data parallelism
        sums = batch_norm_stats(y.movedim(1, -1).reshape(-1, c))
        if collectives.active() is not None:
            collectives.batch_reduce_(sums)
        n = collectives.global_rows(b) * t * f
        mean = sums[0] / n
        var = sums[1] / n - mean.square()
        inv = torch.rsqrt(var + eps)
        scale, shift = bn_affine(mean, inv, gamma, beta, y.dtype)
        bno = y * scale[:, None, None] + shift[:, None, None]
        m_bno = bno.view(b, c, t // pt, pt, f // pf, pf).amax(dim=(3, 5))
        del bno
        pooled = torch.relu(m_bno)
        ctx.save_for_backward(x_pad, kernel, y, mean, var, gamma, beta,
                              m_bno)
        ctx.pool, ctx.eps, ctx.pads = (pt, pf), eps, pads
        ctx.bias_dtype = bias.dtype
        # the batch's count, read here: the backward may run on another
        # thread (the autograd engine's, for a card's tensors), which does
        # not see this thread's data-parallel step
        ctx.dp = collectives.active() is not None
        ctx.group = collectives.batch_group()
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return pooled.movedim(1, -1), mean, var

    @staticmethod
    def backward(ctx, dpooled, _dmean, _dvar):
        # mean/var feed the running statistics only: no gradient
        x_pad, kernel, y, mean, var, gamma, beta, m_bno = ctx.saved_tensors
        t, f = y.shape[2:]
        n = ctx.n
        inv = torch.rsqrt(var + ctx.eps)
        gamma_f, beta_f = gamma.float(), beta.float()

        # dgamma/dbeta from the saved pool max: pooled-size tensors only
        g = dpooled.movedim(-1, 1).float() * (m_bno > 0)
        dbeta = g.sum(dim=(0, 2, 3))
        safe = torch.where(gamma_f == 0, torch.ones_like(gamma_f), gamma_f)
        xhat_max = torch.where(gamma_f[:, None, None] == 0,
                               torch.zeros((), device=g.device),
                               (m_bno.float() - beta_f[:, None, None])
                               / safe[:, None, None])
        dgamma = (g * xhat_max).sum(dim=(0, 2, 3))
        del g, xhat_max

        dgamma_n, dbeta_n = dgamma, dbeta
        if ctx.dp:
            # the global batch's dgamma and dbeta enter every row's dy; the
            # returned gradients stay this rank's: the step's gradient
            # all-reduce sums them, and dbias, once
            dgamma_n, dbeta_n = collectives.all_reduce_(
                torch.stack([dgamma, dbeta]), ctx.group).unbind(0)
        params6 = torch.stack([mean, inv, gamma_f, beta_f, dgamma_n / n,
                               dbeta_n / n])
        # dy overwrites y: y is dead after this pass. A second backward
        # through the same graph then finds y's version moved and raises.
        y_cl = y.movedim(1, -1)
        dy_cl, dbias = stem_dy(y_cl, dpooled, params6, ctx.pool, out=y_cl)
        torch.autograd.graph.increment_version(y)
        dy = dy_cl.movedim(-1, 1)

        w = kernel.permute(3, 2, 0, 1)
        dx = None
        if ctx.needs_input_grad[0]:
            dx_pad = torch.nn.grad.conv2d_input(x_pad.shape, w, dy)
            (t0, _), (f0, _) = ctx.pads
            dx = dx_pad[:, :, t0:t0 + t, f0:f0 + f].movedim(1, -1)
        dkernel = None
        if ctx.needs_input_grad[1]:
            dkernel = torch.nn.grad.conv2d_weight(
                x_pad, w.shape, dy).permute(2, 3, 1, 0)       # OIHW -> HWIO
        return (dx, dkernel, dbias.to(ctx.bias_dtype),
                dgamma.to(gamma.dtype), dbeta.to(beta.dtype), None, None)


def conv_bn_relu_pool(x: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, pool: Tuple[int, int], eps: float):
    """Returns (pooled [B, T/pt, F/pf, C_out], batch_mean, batch_var).

    x [B, T, F, C_in] and kernel [kh, kw, C_in, C_out] (HWIO) share one
    dtype (f32 or bf16); bias, gamma, beta are [C_out]. mean/var are f32
    and carry no gradient. pool must divide T and F.
    """
    return _ConvBNReLUPool.apply(x, kernel, bias, gamma, beta,
                                 tuple(int(p) for p in pool), float(eps))


def fused_stem_applicable(x_shape, pool, strides, padding: str,
                          groups: int, activation) -> bool:
    """The fused path's shape rules: a pool that divides T and F, unit conv
    stride, SAME padding, no groups, ReLU. It is taken on every device."""
    if pool is None or activation != "relu" or groups != 1 \
            or padding.upper() != "SAME" or tuple(strides) != (1, 1):
        return False
    t, f = x_shape[1], x_shape[2]
    return t % pool[0] == 0 and f % pool[1] == 0
