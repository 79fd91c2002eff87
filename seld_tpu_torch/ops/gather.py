"""Row gather for the device-resident feed (seld_tpu/ops/pallas/gather.py).

`gather_batch(arrays, ids)` is `a[ids]` along axis 0 for one or two arrays
with one ids vector; `gather_rows(x, ids)` is its one-array case. On CUDA
tensors it launches the hand-written sm_90a kernel in csrc/gather_rows.cu
once for all the arrays (the feed gathers a batch's x and y together);
that kernel serves both of the JAX package's TPU kernels (the pipelined
lane-row copy and the packed DMA ring). On CPU tensors it runs
`gather_batch_ref` (`a[ids]`, which raises on an id out of range). A CUDA
input the kernel does not take raises. The ids must lie in [0, N): the
kernel does not clamp them, as XLA's gather would.

The wrapper's host work is the call's cost for small rows (the labels'
5.9 MB take 1.8 us at the card's memory rate), so it makes one combined
check, launches through `kernels.launch` (the raw current stream, no
device switch when the tensors lie on the current card) and never
synchronises.

`packed_rows`, `pack_rows` and `unpack_rows` copy the JAX package's packed
[N, rp, 128] staging layout, so its packed case has a twin here; the
kernel gathers a packed array like any other.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from seld_tpu_torch.ops import kernels

_SOURCE = "gather_rows.cu"
_LANES = 128
_SUBLANES = 8
_MAX_ROWS = 65535      # the kernel's grid.y
_MAX_ARRAYS = 2        # the kernel copies one or two arrays a launch


def gather_batch_ref(arrays: Sequence[torch.Tensor],
                     ids: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: a[ids] along axis 0 for each array."""
    return tuple(a[ids.long()] for a in arrays)


def gather_rows_ref(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `gather_rows`: x[ids] along axis 0."""
    return gather_batch_ref((x,), ids)[0]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load(_SOURCE)
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.seld_gather_batch.argtypes = [vp, ctypes.c_int, vp, vp, ll, vp, vp,
                                      ll, vp]
    lib.seld_gather_batch.restype = ctypes.c_int
    return lib


def _raise_bad_args(arrays, ids) -> None:
    """Name what the kernel does not take (the slow path of the check)."""
    if not 1 <= len(arrays) <= _MAX_ARRAYS:
        raise ValueError(f"gather_batch takes 1 to {_MAX_ARRAYS} arrays; got "
                         f"{len(arrays)}")
    for a in arrays:
        if a.dim() < 1 or not a.is_contiguous():
            raise ValueError("gather_batch takes contiguous arrays with a row "
                             f"axis; got {tuple(a.shape)} strides {a.stride()}")
        if a.device != arrays[0].device:
            raise ValueError(f"arrays on {a.device} and {arrays[0].device}")
    if ids.dim() != 1 or ids.dtype != torch.int32 or \
            ids.device != arrays[0].device or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D int32 tensor on the "
                         f"arrays' device; got {tuple(ids.shape)} {ids.dtype} "
                         f"on {ids.device}")
    raise ValueError(f"gather_batch takes at most {_MAX_ROWS} ids; got "
                     f"{ids.shape[0]}")


def _gather_batch_cuda(arrays, ids):
    dev = arrays[0].get_device()
    if not (1 <= len(arrays) <= _MAX_ARRAYS and ids.dtype is torch.int32
            and ids.dim() == 1 and ids.is_contiguous()
            and ids.get_device() == dev and ids.shape[0] <= _MAX_ROWS
            and all(a.get_device() == dev and a.dim() >= 1
                    and a.is_contiguous() for a in arrays)):
        _raise_bad_args(arrays, ids)
    b = ids.shape[0]
    outs = tuple(a.new_empty((b,) + a.shape[1:]) for a in arrays)
    if b == 0:
        return outs
    args = []
    for a, out in zip(arrays, outs):
        row_bytes = math.prod(a.shape[1:]) * a.element_size() \
            if a.shape[0] else 0
        args += [a.data_ptr(), out.data_ptr(), row_bytes]
    if len(arrays) == 1:
        args += [None, None, 0]
    kernels.launch("gather_rows", _library().seld_gather_batch,
                   "gather_rows launch", dev, ids.data_ptr(), b, *args)
    return outs


def gather_batch(arrays: Sequence[torch.Tensor],
                 ids: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """`tuple(a[ids] for a in arrays)` along axis 0, for one or two arrays
    and a 1-D integer `ids` (int32 on the card): one kernel launch on CUDA
    tensors.

    CPU tensors run `gather_batch_ref`; CUDA tensors run the kernel or
    raise."""
    arrays = tuple(arrays)
    kind = arrays[0].device.type if arrays else None
    if kind == "cpu":
        return gather_batch_ref(arrays, ids)
    if kind == "cuda":
        return _gather_batch_cuda(arrays, ids)
    raise ValueError(f"gather_batch runs on cpu or cuda, not {kind}")


def gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`x[ids]` along axis 0 for a 1-D integer `ids` (int32 on the card):
    `gather_batch`'s one-array case."""
    return gather_batch((x,), ids)[0]


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
