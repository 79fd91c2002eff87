"""The fused stem backward's one full-resolution pass
(seld_tpu/ops/pallas/stem_bwd.py).

`stem_dy` reads the conv output y [B, T, F, C] and the pooled cotangent
dpooled [B, T/pt, F/pf, C], recomputes the BatchNorm affine, the ReLU mask
and the pool routing (equality against the window max, ties split by count)
and folds in the BatchNorm-backward terms, giving dy (the gradient with
respect to y) and dbias = sum(dy). On a CUDA tensor it launches the
hand-written sm_90a kernel in csrc/stem_dy.cu; on a CPU tensor it runs
`stem_dy_ref`, the plain PyTorch version (the JAX package's `_dy_xla`,
seld_tpu/ops/stem.py:103-120). The kernel takes any pool window and any
strides: `_vector_path` picks its vector path (16-byte vectors of
channels, the window a compile-time constant of `_VEC_WINDOWS`) where the
layout allows, else its generic path. A CUDA tensor the kernel does not
take raises.

Routing compares against the window max of the recomputed affine, so the
affine must be recomputed exactly as the forward computed it: `bn_affine`
is the one definition of scale/shift that the forward (ops/stem.py) and
the plain version here use, and the kernel repeats it operation for
operation; the product and sum then run in y's dtype, rounding after
each, as PyTorch's eager `y * scale + shift` does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from seld_tpu_torch.ops import kernels

_SOURCE = "stem_dy.cu"
# csrc/stem_dy.cu's kVecWindows: the pool windows of the vector path (the
# SS5 stem's and conv_temporal's default)
_VEC_WINDOWS = ((5, 2), (5, 1))
_THREADS = 256            # kThreads: a block of either path
_MAX_BLOCKS = 1056        # kMaxBlocks: the grid strides over the rest
_ROWS = 8                 # kRows: the generic path's windows a block step
_MAX_CHANNELS = 256       # kLanes * 8: a block's dbias row


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


def _max_offset(a: torch.Tensor) -> int:
    """The largest element offset a view reaches from its first element."""
    return sum((n - 1) * st for n, st in zip(a.shape, a.stride()) if n)


def _check_cuda_args(y, dpooled, params6, pool, out):
    if y.dim() != 4:
        raise ValueError(f"y must be [B, T, F, C]; got {tuple(y.shape)}")
    b, t, f, c = y.shape
    pt, pf = pool
    if pt < 1 or pf < 1 or t % pt or f % pf:
        raise ValueError(f"pool {tuple(pool)} must divide T={t} and F={f}")
    if tuple(dpooled.shape) != (b, t // pt, f // pf, c):
        raise ValueError(f"dpooled {tuple(dpooled.shape)} does not match y "
                         f"{tuple(y.shape)} under pool {tuple(pool)}")
    if tuple(params6.shape) != (6, c) or params6.dtype != torch.float32:
        raise ValueError(f"params6 must be [6, {c}] float32; got "
                         f"{tuple(params6.shape)} {params6.dtype}")
    if c > _MAX_CHANNELS:
        raise ValueError(f"C={c}: the kernel takes at most {_MAX_CHANNELS} "
                         "channels")
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
    if any(st < 0 for a in (y, dpooled) for st in a.stride()):
        raise ValueError("y and dpooled need non-negative strides")
    if max(_max_offset(y), _max_offset(dpooled)) >= 2 ** 31:
        raise ValueError("y is too large for the kernel's 32-bit indices")


def _vector_path(y, pool) -> bool:
    """Whether csrc/stem_dy.cu takes its vector path: a window of
    `_VEC_WINDOWS`, C innermost and unit-stride in y, y's (and out's) other
    strides whole 16-byte vectors of V channels (8 bf16, 4 f32), C / V a
    power of two up to 32, and y 16-byte aligned. It reads dpooled element
    by element with its strides (the training step hands it over
    channels-first)."""
    c = y.shape[-1]
    v = 16 // y.element_size()
    nv = c // v
    ys = y.stride()
    return (tuple(pool) in _VEC_WINDOWS and c % v == 0
            and 1 <= nv <= 32 and nv & (nv - 1) == 0 and ys[3] == 1
            and all(st % v == 0 for st in ys[:3])
            and y.data_ptr() % 16 == 0)


def _blocks(shape, pool, vec: bool, elem_bytes: int) -> int:
    """Blocks of the kernel's grid (the rows of its dbias partials): one
    (window, channel vector) item a thread on the vector path, 8 windows a
    block step on the generic path, capped at `_MAX_BLOCKS`."""
    b, t, f, c = shape
    n_win = b * (t // pool[0]) * (f // pool[1])
    work = -(-n_win * (c // (16 // elem_bytes)) // _THREADS) if vec \
        else -(-n_win // _ROWS)
    return max(1, min(work, _MAX_BLOCKS))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load(_SOURCE)
    lib.seld_stem_dy.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 18 + [ctypes.c_void_p]
    lib.seld_stem_dy.restype = ctypes.c_int
    lib.seld_stem_dy_vec_windows.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.seld_stem_dy_vec_windows.restype = ctypes.c_int
    return lib


def library_vec_windows() -> tuple:
    """The vector path's windows compiled into csrc/stem_dy.cu, to hold
    `_VEC_WINDOWS` against (loads the library)."""
    buf = (ctypes.c_int * 32)()
    n = _library().seld_stem_dy_vec_windows(buf, 32)
    return tuple(tuple(buf[2 * i:2 * i + 2]) for i in range(n))


def _stem_dy_cuda(y, dpooled, params6, pool, out):
    _check_cuda_args(y, dpooled, params6, pool, out)
    b, t, f, c = y.shape
    pt, pf = pool
    vec = _vector_path(y, pool) and out.data_ptr() % 16 == 0
    blocks = _blocks(y.shape, pool, vec, y.element_size())
    # the blocks' dbias partial rows, then dbias itself
    work = torch.empty((blocks + 1, c), dtype=torch.float32, device=y.device)
    kernels.launch("stem_dy", _library().seld_stem_dy, "stem_dy launch",
                   y.get_device(), y.data_ptr(), dpooled.data_ptr(),
                   params6.data_ptr(), out.data_ptr(), work.data_ptr(),
                   work[blocks].data_ptr(), b, t, f, c, pt, pf, *y.stride(),
                   *dpooled.stride(), int(y.dtype == torch.bfloat16),
                   int(dpooled.dtype == torch.bfloat16), int(vec), blocks)
    return out, work[blocks]


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
