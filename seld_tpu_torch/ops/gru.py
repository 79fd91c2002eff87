"""Fused (bi)directional GRU recurrence (seld_tpu/ops/pallas/gru.py).

`gru_scan` runs the Keras reset_after recurrence (z|r|h gate order) for one
or two directions over a precomputed input projection. On a CUDA tensor it
launches the hand-written sm_90a kernel in csrc/gru_fwd.cu; on a CPU tensor
it runs `gru_scan_ref`, the plain PyTorch version of the same arithmetic.
There is no fallback from the kernel to the plain version: a CUDA tensor
the kernel does not take raises.

The input projection `x @ kernel + bias[:, 0]` stays one large
`torch.einsum` (`gru_forward`), as the JAX package leaves it to XLA; only the
recurrence is the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from seld_tpu_torch.ops import kernels

_SOURCE = "gru_fwd.cu"
_MAX_SMEM = 232448   # bytes of shared memory one H100 block may use


def gru_scan_ref(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                 rec_bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence with the kernel's layout and f32 gate math.

    x_proj [D, T, B, 3U], rec_kernel [D, U, 3U], rec_bias [D, 3U] ->
    hs [D, T, B, U] in x_proj's dtype; d=1 runs in descending time and its
    states land at their real t.
    """
    d_dirs, t_steps, b, k = x_proj.shape
    u = k // 3
    rk = rec_kernel.float()
    rb = rec_bias.float()
    hs = torch.empty((d_dirs, t_steps, b, u), dtype=torch.float32,
                     device=x_proj.device)
    for d in range(d_dirs):
        h = torch.zeros((b, u), dtype=torch.float32, device=x_proj.device)
        order = range(t_steps) if d == 0 else range(t_steps - 1, -1, -1)
        for t in order:
            hp = h @ rk[d] + rb[d]
            xp = x_proj[d, t].float()
            z = torch.sigmoid(xp[:, :u] + hp[:, :u])
            r = torch.sigmoid(xp[:, u:2 * u] + hp[:, u:2 * u])
            hcand = torch.tanh(xp[:, 2 * u:] + r * hp[:, 2 * u:])
            h = z * h + (1.0 - z) * hcand
            hs[d, t] = h
    return hs.to(x_proj.dtype)


def _check_cuda_args(x_proj, rec_kernel, rec_bias):
    if x_proj.dim() != 4 or x_proj.shape[-1] % 3:
        raise ValueError(f"x_proj must be [D, T, B, 3U]; got "
                         f"{tuple(x_proj.shape)}")
    d, t, b, k = x_proj.shape
    u = k // 3
    if d not in (1, 2):
        raise ValueError(f"x_proj has {d} directions; the kernel takes 1 or 2")
    if tuple(rec_kernel.shape) != (d, u, k) or \
            tuple(rec_bias.shape) != (d, k):
        raise ValueError(f"rec_kernel {tuple(rec_kernel.shape)} / rec_bias "
                         f"{tuple(rec_bias.shape)} do not match x_proj "
                         f"{tuple(x_proj.shape)}")
    if x_proj.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x_proj dtype {x_proj.dtype}; the kernel takes "
                        "float32 or bfloat16")
    for name, w in (("rec_kernel", rec_kernel), ("rec_bias", rec_bias)):
        if w.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} dtype {w.dtype}; the kernel takes "
                            "float32 or bfloat16")
    for name, a in (("x_proj", x_proj), ("rec_kernel", rec_kernel),
                    ("rec_bias", rec_bias)):
        if a.device != x_proj.device:
            raise ValueError(f"{name} is on {a.device}, x_proj on "
                             f"{x_proj.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if u % 4 or k > 1024:
        raise ValueError(f"U={u}: the kernel needs U % 4 == 0 and 3U <= 1024")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load(_SOURCE)
    lib.seld_gru_fwd.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.seld_gru_fwd.restype = ctypes.c_int
    lib.seld_gru_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.seld_gru_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _gru_scan_cuda(x_proj, rec_kernel, rec_bias):
    _check_cuda_args(x_proj, rec_kernel, rec_bias)
    d, t, b, k = x_proj.shape
    u = k // 3
    lib = _library()
    smem = lib.seld_gru_fwd_smem_bytes(u)
    if smem > _MAX_SMEM:
        raise ValueError(f"U={u} needs {smem} B of shared memory; a block "
                         f"has {_MAX_SMEM}")
    hs = torch.empty((d, t, b, u), dtype=x_proj.dtype, device=x_proj.device)
    if hs.numel() == 0:
        return hs
    # weights are tiny ([D, U, 3U]); the kernel reads them as f32
    rk = rec_kernel.float().contiguous()
    rb = rec_bias.float().contiguous()
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        err = lib.seld_gru_fwd(x_proj.data_ptr(), rk.data_ptr(),
                               rb.data_ptr(), hs.data_ptr(), d, t, b, u,
                               int(x_proj.dtype == torch.bfloat16), stream)
    kernels.check(lib, err, "gru_fwd launch")
    kernels.launch_counts["gru_scan"] += 1
    return hs


def gru_scan(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
             rec_bias: torch.Tensor) -> torch.Tensor:
    """Fused GRU recurrence.

    Args:
      x_proj:     [D, T, B, 3U] input projection incl. input bias
                  (z|r|h gate layout, Keras order), float32 or bfloat16
      rec_kernel: [D, U, 3U]
      rec_bias:   [D, 3U] recurrent bias (reset_after)

    Returns hs [D, T, B, U] in x_proj's dtype — REAL-time indexed for both
    directions. A CPU tensor runs `gru_scan_ref`; a CUDA tensor runs the
    kernel or raises.
    """
    if x_proj.device.type == "cpu":
        return gru_scan_ref(x_proj, rec_kernel, rec_bias)
    if x_proj.device.type == "cuda":
        return _gru_scan_cuda(x_proj, rec_kernel, rec_bias)
    raise ValueError(f"gru_scan runs on cpu or cuda, not {x_proj.device}")


def gru_forward(x: torch.Tensor, kernel: torch.Tensor,
                rec_kernel: torch.Tensor, bias: torch.Tensor, *,
                bidirectional: bool, merge_mode: str = "mul") -> torch.Tensor:
    """Full GRU layer forward.

    x [B, T, I]; kernel [D, I, 3U]; rec_kernel [D, U, 3U]; bias [D, 2, 3U].
    Returns [B, T, U*dirs] ('concat') or [B, T, U] (other merges), matching
    seld_tpu.models.layers.GRU.
    """
    from seld_tpu_torch.models.layers import merge_bidirectional

    dt = torch.promote_types(x.dtype, kernel.dtype)
    # one large product for all timesteps/directions; bias[:, 0] = input
    x_proj = torch.einsum("bti,dik->dtbk", x.to(dt), kernel.to(dt))
    x_proj = (x_proj + bias[:, None, None, 0].to(dt)).contiguous()
    hs = gru_scan(x_proj, rec_kernel, bias[:, 1].contiguous())  # [D,T,B,U]
    hs = hs.transpose(1, 2)                                   # [D,B,T,U]
    if not bidirectional:
        return hs[0]
    return merge_bidirectional(hs[0], hs[1], merge_mode)
