"""Row gather for the device-resident feed (seld_tpu/ops/pallas/gather.py).

`gather_rows(x, ids)` is `x[ids]` along axis 0. On a CUDA tensor it launches
the hand-written sm_90a kernel in csrc/gather_rows.cu, which serves both of
the JAX package's TPU kernels (the pipelined lane-row copy and the packed
DMA ring); on a CPU tensor it runs `gather_rows_ref` (`x[ids]`, which
raises on an id out of range). A CUDA tensor the kernel does not take
raises. The ids must lie in [0, N): the kernel does not clamp them, as
XLA's gather would.

`packed_rows`, `pack_rows` and `unpack_rows` copy the JAX package's packed
[N, rp, 128] staging layout, so its packed case has a twin here; the
kernel gathers a packed array like any other.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from seld_tpu_torch.ops import kernels

_SOURCE = "gather_rows.cu"
_LANES = 128
_SUBLANES = 8
_MAX_ROWS = 65535      # the kernel's grid.y


def gather_rows_ref(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x[ids] along axis 0."""
    return x[ids.long()]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load(_SOURCE)
    lib.seld_gather_rows.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.seld_gather_rows.restype = ctypes.c_int
    return lib


def _gather_rows_cuda(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if not x.is_contiguous() or x.dim() < 1:
        raise ValueError("gather_rows takes a contiguous x with a row axis")
    if ids.dim() != 1 or ids.dtype != torch.int32 or ids.device != x.device \
            or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D int32 tensor on x's "
                         f"device; got {tuple(ids.shape)} {ids.dtype} on "
                         f"{ids.device}")
    b = ids.shape[0]
    if b > _MAX_ROWS:
        raise ValueError(f"gather_rows takes at most {_MAX_ROWS} ids; got {b}")
    out = torch.empty((b, *x.shape[1:]), dtype=x.dtype, device=x.device)
    row_bytes = x[0].numel() * x.element_size() if x.shape[0] else 0
    if b == 0 or row_bytes == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.seld_gather_rows(x.data_ptr(), ids.data_ptr(),
                                   out.data_ptr(), b, row_bytes, stream)
    kernels.check(lib, err, "gather_rows launch")
    kernels.launch_counts["gather_rows"] += 1
    return out


def gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`x[ids]` along axis 0 for a 1-D integer `ids` (int32 on the card).

    A CPU tensor runs `gather_rows_ref`; a CUDA tensor runs the kernel or
    raises."""
    if x.device.type == "cpu":
        return gather_rows_ref(x, ids)
    if x.device.type == "cuda":
        return _gather_rows_cuda(x, ids)
    raise ValueError(f"gather_rows runs on cpu or cuda, not {x.device}")


def packed_rows(row_shape) -> int:
    """Sublane rows (dim 1 of the packed [N, rp, 128] layout) for a logical
    per-item shape: rows padded up to a whole number of (8, 128) tiles."""
    row = 1
    for d in row_shape:
        row *= d
    r = -(-row // _LANES)
    return -(-r // _SUBLANES) * _SUBLANES


def pack_rows(x: np.ndarray) -> np.ndarray:
    """Host-side: [N, ...] -> [N, rp, 128] zero-padded packed layout."""
    n = x.shape[0]
    row = int(np.prod(x.shape[1:]))
    rp = packed_rows(x.shape[1:])
    flat = np.ascontiguousarray(x).reshape(n, row)
    if rp * _LANES == row:
        return flat.reshape(n, rp, _LANES)
    out = np.zeros((n, rp, _LANES), x.dtype)
    out.reshape(n, -1)[:, :row] = flat
    return out


def unpack_rows(xb, row_shape):
    """[B, rp, 128] packed batch -> [B, *row_shape]."""
    b = xb.shape[0]
    row = 1
    for d in row_shape:
        row *= d
    return xb.reshape(b, -1)[:, :row].reshape(b, *row_shape)
