"""The fused stem backward's one full-resolution pass
(seld_tpu/ops/pallas/stem_bwd.py).

`stem_dy` reads the conv output y [B, T, F, C] and the pooled cotangent
dpooled [B, T/pt, F/pf, C], recomputes the BatchNorm affine, the ReLU mask
and the pool routing (equality against the window max, ties split by count)
and folds in the BatchNorm-backward terms, giving dy (the gradient with
respect to y) and dbias = sum(dy). On a CUDA tensor it launches the
hand-written sm_90a kernel in csrc/stem_dy.cu; on a CPU tensor it runs
`stem_dy_ref`, the plain PyTorch version (the JAX package's `_dy_xla`,
seld_tpu/ops/stem.py:103-120). A CUDA tensor the kernel does not take
raises.

Routing compares against the window max of the recomputed affine, so the
affine must be recomputed exactly as the forward computed it: `bn_affine`
is the one definition of scale/shift that the forward (ops/stem.py) and
both versions here use, and the product and sum then run in y's dtype,
rounding after each, as PyTorch's eager `y * scale + shift` does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from seld_tpu_torch.ops import kernels

_SOURCE = "stem_dy.cu"
_MAX_WINDOW = 16          # pool window elements the kernel holds per thread
_WINDOWS_PER_BLOCK = 32   # csrc/stem_dy.cu kWinPerBlock


def bn_affine(mean: torch.Tensor, inv: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor, dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, shift) of the train-mode BatchNorm, cast to y's dtype:
    scale = gamma * inv, shift = beta - gamma * mean * inv
    (seld_tpu/ops/stem.py:79-80)."""
    scale = (gamma * inv).to(dtype)
    shift = (beta - gamma * mean * inv).to(dtype)
    return scale, shift


def stem_dy_ref(y: torch.Tensor, dpooled: torch.Tensor,
                params6: torch.Tensor, pool: Sequence[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch dy + dbias through a window-split view."""
    mean, inv, gamma, beta, dgn, dbn = params6.float().unbind(0)
    b, t, f, c = y.shape
    pt, pf = pool
    scale, shift = bn_affine(mean, inv, gamma, beta, y.dtype)
    bno = (y * scale + shift).float()
    bno6 = bno.reshape(b, t // pt, pt, f // pf, pf, c)
    m = bno6.amax(dim=(2, 4), keepdim=True)
    eq = ((bno6 == m) & (bno6 > 0)).float()
    cnt = eq.sum(dim=(2, 4), keepdim=True)
    dp6 = dpooled.float()[:, :, None, :, None, :]
    dyr = (eq * (dp6 / cnt.clamp_min(1.0))).reshape(b, t, f, c)
    xhat = (y.float() - mean) * inv
    dy = (inv * gamma) * (dyr - dbn - xhat * dgn)
    return dy.to(y.dtype), dy.sum(dim=(0, 1, 2))


def _check_cuda_args(y, dpooled, params6, pool, out):
    if y.dim() != 4:
        raise ValueError(f"y must be [B, T, F, C]; got {tuple(y.shape)}")
    b, t, f, c = y.shape
    pt, pf = pool
    if pt < 1 or pf < 1 or t % pt or f % pf:
        raise ValueError(f"pool {tuple(pool)} must divide T={t} and F={f}")
    if pt * pf > _MAX_WINDOW:
        raise ValueError(f"pool window {pt}x{pf} has more than "
                         f"{_MAX_WINDOW} elements")
    if tuple(dpooled.shape) != (b, t // pt, f // pf, c):
        raise ValueError(f"dpooled {tuple(dpooled.shape)} does not match y "
                         f"{tuple(y.shape)} under pool {tuple(pool)}")
    if tuple(params6.shape) != (6, c) or params6.dtype != torch.float32:
        raise ValueError(f"params6 must be [6, {c}] float32; got "
                         f"{tuple(params6.shape)} {params6.dtype}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"y dtype {y.dtype}; the kernel takes float32 or "
                        "bfloat16")
    if dpooled.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dpooled dtype {dpooled.dtype}; the kernel takes "
                        "float32 or bfloat16")
    if out.shape != y.shape or out.stride() != y.stride() or \
            out.dtype != y.dtype:
        raise ValueError("out must have y's shape, strides and dtype")
    for name, a in (("dpooled", dpooled), ("params6", params6),
                    ("out", out)):
        if a.device != y.device:
            raise ValueError(f"{name} is on {a.device}, y on {y.device}")
    if not params6.is_contiguous():
        raise ValueError("params6 must be contiguous")
    if y.numel() >= 2 ** 31:
        raise ValueError("y is too large for the kernel's 32-bit indices")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load(_SOURCE)
    lib.seld_stem_dy.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 16 + [ctypes.c_void_p]
    lib.seld_stem_dy.restype = ctypes.c_int
    return lib


def _stem_dy_cuda(y, dpooled, params6, pool, out):
    _check_cuda_args(y, dpooled, params6, pool, out)
    b, t, f, c = y.shape
    pt, pf = pool
    lib = _library()
    mean, inv, gamma, beta = params6[:4]
    # scale/shift exactly as the forward computed them (bn_affine), handed
    # to the kernel as f32 values of y's dtype
    scale, shift = bn_affine(mean, inv, gamma, beta, y.dtype)
    affine = torch.stack([scale, shift]).float().contiguous()
    blocks = -(-b * (t // pt) * (f // pf) // _WINDOWS_PER_BLOCK)
    partial = torch.empty((blocks, c), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.seld_stem_dy(
            y.data_ptr(), dpooled.data_ptr(), params6.data_ptr(),
            affine.data_ptr(), out.data_ptr(), partial.data_ptr(),
            b, t, f, c, pt, pf, *y.stride(), *dpooled.stride(),
            int(y.dtype == torch.bfloat16),
            int(dpooled.dtype == torch.bfloat16), stream)
    kernels.check(lib, err, "stem_dy launch")
    kernels.launch_counts["stem_dy"] += 1
    # per-block partials of dbias, summed outside the kernel as the JAX
    # package does (seld_tpu/ops/pallas/stem_bwd.py:125-127)
    return out, partial.sum(dim=0)


def stem_dy(y: torch.Tensor, dpooled: torch.Tensor, params6: torch.Tensor,
            pool: Sequence[int], *, out: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dy + dbias for the fused stem backward.

    Args:
      y:       [B, T, F, C] conv output (+bias), storage dtype, any strides
               (the stem's is the conv's channels-last buffer).
      dpooled: [B, T/pt, F/pf, C] cotangent of the pooled output.
      params6: [6, C] f32 rows: mean, rsqrt(var+eps), gamma, beta,
               dgamma/n, dbeta/n.
      pool:    (pt, pf); both must divide T/F.
      out:     where to write dy (y's shape, strides and dtype); it may be y
               itself, since every window is read whole before it is
               written. A new tensor like y when None.

    Returns (dy [B, T, F, C] in y.dtype, dbias [C] f32). A CPU tensor runs
    `stem_dy_ref`; a CUDA tensor runs the kernel or raises.
    """
    pool = tuple(int(p) for p in pool)
    if y.device.type == "cpu":
        dy, dbias = stem_dy_ref(y, dpooled, params6, pool)
        if out is not None:
            dy = out.copy_(dy)
        return dy, dbias
    if y.device.type == "cuda":
        if out is None:
            out = torch.empty_like(y)   # keeps y's strides
        return _stem_dy_cuda(y, dpooled, params6, pool, out)
    raise ValueError(f"stem_dy runs on cpu or cuda, not {y.device}")
