"""Train-mode BatchNorm over the last axis as four hand-written passes
(csrc/batch_norm.cu): the batch statistics, the normalisation and their
backward.

Each pass works on the [rows, C] view of a tensor contiguous along its
last axis C, in f32 or bf16, with f32 arithmetic throughout:
  1. `batch_norm_stats(x)`: [sum x, sum x^2] per channel, [2, C] f32;
  2. `batch_norm_apply(x, sums, scale, bias, n, eps, dtype)`: mean =
     sums[0] / n, var = sums[1] / n - mean^2 (the biased E[x^2] - E[x]^2 of
     models/layers.py and the JAX package), inv = rsqrt(var + eps), y = (x
     - mean) * a + bias with a = inv * scale formed once a channel (the
     reference's form), y in `dtype`; also the moments [3, C] = [mean, var,
     inv];
  3. `batch_norm_grad_sums(x, dy, moments)`: [sum dy, sum dy * xhat], [2,
     C] f32, xhat = (x - mean) * inv recomputed from x;
  4. `batch_norm_grad_apply(x, dy, moments, scale, dsums, n)`: dx = scale *
     inv * (dy - dsums[0] / n - xhat * dsums[1] / n) in x's dtype.
On a CUDA tensor each launches its kernel (one launch count each, under
"batch_norm"); on a CPU tensor it runs its plain PyTorch twin (`*_ref`).
A CUDA tensor the kernels do not take raises.

`batch_norm_train(x, scale, bias, eps)` is the train-mode BatchNorm as
one autograd Function over these passes, returning (y, moments). It saves
x (which the layer before keeps alive), the moments and scale: no f32
copy. Inside a data-parallel step (parallel/collectives.py) pass 1's sums
and pass 3's sums are all-reduced over the batch's group, and n is the
global count, so each rank normalises and differentiates with the global
batch's terms; the returned dscale and dbias stay this rank's, which the
step's gradient all-reduce sums. The group and the count are read in the
forward: the backward may run on another thread (the autograd engine's,
for a card's tensors).

`batch_norm_relu_pool_train(x, scale, bias, eps, window)` is a train-mode
BatchNorm of x [B, T, F, C] whose result goes straight to ReLU and a
VALID max pool with strides equal to `window` (which divides T and F), as
one autograd Function over pass 1 and three more passes ("batch_norm_pool"
launch counts):
  2'. `batch_norm_pool_apply`: only the pooled tensor [B, T/wt, F/wf, C] in
      y's dtype, and a one-byte count a pooled element of its window's
      elements equal to the maximum;
  3'. `batch_norm_pool_grad_sums`: first each pooled element's share, dp /
      count rounded to y's dtype where p > 0 and 0 elsewhere (PyTorch's
      amax backward, then ReLU's), then pass 3 on dy recomputed a row
      from x, the moments, the parameters and the row's window: y == p
      takes the window's share, every other element 0;
  4'. `batch_norm_pool_grad_apply`: pass 4 on that dy, from 3' shares.
y is recomputed as pass 2 rounds it and 3' and 4' walk passes 3 and 4's
plan, so the Function equals the composed BatchNorm -> relu -> max_pool
bit for bit. It saves x, the pooled tensor and the counts: no full-size
activation beside x. `batch_norm_pool_applicable` says where it applies.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from seld_tpu_torch.ops import kernels
from seld_tpu_torch.ops.pooling import _windows
from seld_tpu_torch.parallel import collectives

_SOURCE = "batch_norm.cu"
_KERNEL = "batch_norm"
_POOL_KERNEL = "batch_norm_pool"


# ---------------------------------------------------------------- twins
# The plain versions add their sums in the kernels' order (`_plan`,
# `_ordered_sum`), each product and sum rounded on its own, so passes 1 and
# 3 give the kernels' sums bit for bit.

_THREADS = 256          # csrc/batch_norm.cu's kThreads
_UNROLL = 4             # kUnroll
_MAX_BLOCKS = 4096      # kMaxPartials: blocks along the rows
_LANES = 32             # kFinalRows: the finalize's row lanes


def _width(x: torch.Tensor, c: int) -> int:
    """Channels a thread: x's 16-byte vector where C is a multiple of it
    (the kernels also need aligned pointers, as a fresh tensor's are)."""
    n = 16 // x.element_size()
    return n if c % n == 0 else 1


def _plan(rows: int, c: int, n: int) -> Tuple[int, int]:
    """(R, G): the row lanes of a block and the blocks along the rows of
    csrc/batch_norm.cu's `plan` at n channels a thread."""
    r = _THREADS // min(c // n, _THREADS)
    return r, min(-(-rows // (r * _UNROLL)), _MAX_BLOCKS)


def _ordered_sum(v: torch.Tensor, n: int) -> torch.Tensor:
    """Per-channel sums of v [rows, C] f32 in the kernels' order: thread
    (block g, lane j) adds rows g R + j + k G R in k order, a block its R
    lanes in order, then 32 lanes of blocks (g mod 32) in order and a tree
    over the lanes."""
    rows, c = v.shape
    r, g = _plan(rows, c, n)
    steps = -(-rows // (g * r))
    v = torch.cat([v, v.new_zeros(steps * g * r - rows, c)]).view(
        steps, g, r, c)
    acc = v[0]
    for k in range(1, steps):
        acc = acc + v[k]
    blocks = acc[:, 0]
    for j in range(1, r):
        blocks = blocks + acc[:, j]
    blocks = torch.cat([blocks, blocks.new_zeros(-g % _LANES, c)]).view(
        -1, _LANES, c)
    lanes = v.new_zeros((_LANES, c))
    for i in range(blocks.shape[0]):
        lanes = lanes + blocks[i]
    h = _LANES // 2
    while h:
        lanes = torch.cat([lanes[:h] + lanes[h:2 * h], lanes[h:]])
        h //= 2
    return lanes[0]


def _moments(sums, n, eps):
    mean = sums[0] / n
    var = sums[1] / n - mean.square()
    return torch.stack([mean, var, torch.rsqrt(var + eps)])


def batch_norm_stats_ref(x: torch.Tensor) -> torch.Tensor:
    xf, n = x.float(), _width(x, x.shape[1])
    return torch.stack([_ordered_sum(xf, n), _ordered_sum(xf * xf, n)])


def _affine(x, moments, scale, bias, dtype):
    """Pass 2's y = (x - mean) * a + bias, a = inv * scale, in `dtype`."""
    a = moments[2] * scale.float()
    return ((x.float() - moments[0]) * a + bias.float()).to(dtype)


def batch_norm_apply_ref(x, sums, scale, bias, n, eps, dtype):
    moments = _moments(sums, n, eps)
    return _affine(x, moments, scale, bias, dtype), moments


def _xhat(x, moments):
    return (x.float() - moments[0]) * moments[2]


def batch_norm_grad_sums_ref(x, dy, moments):
    dyf, xhat, n = dy.float(), _xhat(x, moments), _width(x, x.shape[1])
    return torch.stack([_ordered_sum(dyf, n), _ordered_sum(dyf * xhat, n)])


def batch_norm_grad_apply_ref(x, dy, moments, scale, dsums, n):
    k = scale.float() * moments[2]
    dx = k * (dy.float() - dsums[0] / n - _xhat(x, moments) * (dsums[1] / n))
    return dx.to(x.dtype)


def _up(t, window):
    """A pooled [B, T', F', C] tensor at each element of its windows."""
    return t.repeat_interleave(window[0], 1).repeat_interleave(window[1], 2)


def batch_norm_pool_apply_ref(x, sums, scale, bias, n, eps, dtype, window):
    moments = _moments(sums, n, eps)
    r = _windows(torch.relu(_affine(x, moments, scale, bias, dtype)), window)
    p = r.amax(dim=(2, 4))
    count = (r == p[:, :, None, :, None]).sum(dim=(2, 4))
    return p, count.to(torch.uint8), moments


def _share(p, dp, count):
    """What amax's backward sends each of a window's tied maxima: dp /
    count rounded to p's dtype where the maximum p > 0, else 0 (ReLU's
    backward)."""
    share = (dp.float() / count.float()).to(p.dtype)
    return torch.where(p > 0, share, share.new_zeros(()))


def _routed(x, p, share, moments, scale, bias, window):
    """dy [rows, C]: y recomputed as pass 2 rounds it; an element equal to
    its window's maximum takes the window's share, every other 0."""
    y = _affine(x, moments, scale, bias, p.dtype)
    dy = torch.where(y == _up(p, window), _up(share, window),
                     share.new_zeros(()))
    return dy.reshape(-1, x.shape[-1])


def batch_norm_pool_grad_sums_ref(x, p, dp, count, moments, scale, bias,
                                  window):
    share = _share(p, dp, count)
    dy = _routed(x, p, share, moments, scale, bias, window)
    return batch_norm_grad_sums_ref(x.reshape(-1, x.shape[-1]), dy,
                                    moments), share


def batch_norm_pool_grad_apply_ref(x, p, share, moments, scale, bias, window,
                                   dsums, n):
    dy = _routed(x, p, share, moments, scale, bias, window)
    return batch_norm_grad_apply_ref(x.reshape(-1, x.shape[-1]), dy, moments,
                                     scale, dsums, n).view(x.shape)


# ---------------------------------------------------------------- kernels

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load(_SOURCE)
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.seld_batch_norm_stats.argtypes = [vp, i, ll, i, i, i, vp, vp, vp]
    lib.seld_batch_norm_apply.argtypes = [vp, i, vp, i, ll, i, i, vp, vp, vp,
                                          i, f, f, vp, vp]
    lib.seld_batch_norm_grad_sums.argtypes = [vp, i, vp, i, ll, i, i, i, vp,
                                              vp, vp, vp]
    lib.seld_batch_norm_grad_apply.argtypes = [vp, i, vp, i, vp, ll, i, i,
                                               vp, vp, i, vp, f, vp]
    window = [i, i, i, i, i]                   # C, T, F, wt, wf
    lib.seld_batch_norm_pool_apply.argtypes = [vp, i, vp, i, vp, ll, *window,
                                               i, vp, vp, vp, i, f, f, vp, vp]
    lib.seld_batch_norm_pool_grad_sums.argtypes = [
        vp, i, vp, vp, i, vp, vp, ll, *window, i, i, vp, vp, vp, i, vp, vp,
        vp]
    lib.seld_batch_norm_pool_grad_apply.argtypes = [
        vp, i, vp, vp, i, vp, ll, *window, i, vp, vp, vp, i, vp, f, vp]
    for fn in (lib.seld_batch_norm_stats, lib.seld_batch_norm_apply,
               lib.seld_batch_norm_grad_sums, lib.seld_batch_norm_grad_apply,
               lib.seld_batch_norm_pool_apply,
               lib.seld_batch_norm_pool_grad_sums,
               lib.seld_batch_norm_pool_grad_apply):
        fn.restype = i
    return lib


def _is_bf16(t: torch.Tensor) -> int:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {t.dtype}: the kernels take float32 or "
                        "bfloat16")
    return int(t.dtype == torch.bfloat16)


def _check(x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty [rows, C]; got "
                         f"{tuple(x.shape)}")
    for t in (x, *others):
        if t.device != x.device:
            raise ValueError(f"a tensor is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors; got "
                             f"{tuple(t.shape)} strides {t.stride()}")


def _vec(x: torch.Tensor, *others: torch.Tensor) -> int:
    """The 16-byte path: C a multiple of x's 16-byte vector (8 bf16, 4 f32)
    and every pointer aligned to its share of such a vector."""
    n = 16 // x.element_size()
    return int(x.shape[1] % n == 0 and all(
        t.data_ptr() % (n * t.element_size()) == 0 for t in (x, *others)))


def _params(c: int, device, *ps: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """scale, bias ([C], one dtype, f32 or bf16) as the kernels read them."""
    out = tuple(p.contiguous() for p in ps)
    for p in out:
        if tuple(p.shape) != (c,) or p.device != device or \
                p.dtype != out[0].dtype:
            raise ValueError(f"the parameters must be [{c}] of one dtype on "
                             f"{device}; got {tuple(p.shape)} {p.dtype} on "
                             f"{p.device}")
        _is_bf16(p)
    return out


def _f32(t: torch.Tensor, rows: int, c: int, what: str) -> None:
    if tuple(t.shape) != (rows, c) or t.dtype != torch.float32 or \
            not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous [{rows}, {c}] float32; "
                         f"got {tuple(t.shape)} {t.dtype}")


def _partials(x: torch.Tensor, vec: int) -> Tuple[int, torch.Tensor]:
    """(blocks along the rows, their partial rows [blocks, 2, C]) of a
    reduction over x."""
    rows, c = x.shape
    _, blocks = _plan(rows, c, 16 // x.element_size() if vec else 1)
    return blocks, torch.empty((blocks, 2, c), dtype=torch.float32,
                               device=x.device)


def _stats_cuda(x):
    _check(x)
    rows, c = x.shape
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    vec = _vec(x)
    blocks, partial = _partials(x, vec)
    kernels.launch(_KERNEL, _library().seld_batch_norm_stats,
                   "batch_norm_stats launch", x.get_device(), x.data_ptr(),
                   _is_bf16(x), rows, c, vec, blocks, partial.data_ptr(),
                   sums.data_ptr())
    return sums


def _apply_cuda(x, sums, scale, bias, n, eps, dtype):
    _check(x)
    rows, c = x.shape
    _f32(sums, 2, c, "sums")
    scale, bias = _params(c, x.device, scale, bias)
    y = torch.empty((rows, c), dtype=dtype, device=x.device)
    moments = torch.empty((3, c), dtype=torch.float32, device=x.device)
    kernels.launch(_KERNEL, _library().seld_batch_norm_apply,
                   "batch_norm_apply launch", x.get_device(), x.data_ptr(),
                   _is_bf16(x), y.data_ptr(), _is_bf16(y), rows, c,
                   _vec(x, y), sums.data_ptr(), scale.data_ptr(),
                   bias.data_ptr(), _is_bf16(scale), float(n), float(eps),
                   moments.data_ptr())
    return y, moments


def _grad_sums_cuda(x, dy, moments):
    _check(x, dy)
    rows, c = x.shape
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not x's {tuple(x.shape)}")
    _f32(moments, 3, c, "moments")
    dsums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    vec = _vec(x, dy)
    blocks, partial = _partials(x, vec)
    kernels.launch(_KERNEL, _library().seld_batch_norm_grad_sums,
                   "batch_norm_grad_sums launch", x.get_device(),
                   x.data_ptr(), _is_bf16(x), dy.data_ptr(), _is_bf16(dy),
                   rows, c, vec, blocks, moments.data_ptr(),
                   partial.data_ptr(), dsums.data_ptr())
    return dsums


def _grad_apply_cuda(x, dy, moments, scale, dsums, n):
    _check(x, dy)
    rows, c = x.shape
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not x's {tuple(x.shape)}")
    _f32(moments, 3, c, "moments")
    _f32(dsums, 2, c, "dsums")
    scale, = _params(c, x.device, scale)
    dx = torch.empty_like(x)
    kernels.launch(_KERNEL, _library().seld_batch_norm_grad_apply,
                   "batch_norm_grad_apply launch", x.get_device(),
                   x.data_ptr(), _is_bf16(x), dy.data_ptr(), _is_bf16(dy),
                   dx.data_ptr(), rows, c, _vec(x, dy, dx),
                   moments.data_ptr(), scale.data_ptr(), _is_bf16(scale),
                   dsums.data_ptr(), float(n))
    return dx


def _pool_check(x, window, *pooled):
    """x [B, T, F, C] under `window`, which divides T and F; the pooled
    tensors [B, T / wt, F / wf, C], contiguous. -> (rows, C, T, F, wt,
    wf)."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, T, F, C]; got {tuple(x.shape)}")
    b, t, f, c = x.shape
    wt, wf = window
    if t % wt or f % wf:
        raise ValueError(f"the window {tuple(window)} does not divide "
                         f"[T, F] = [{t}, {f}]")
    _check(x.view(-1, c), *pooled)
    for q in pooled:
        if tuple(q.shape) != (b, t // wt, f // wf, c):
            raise ValueError(f"a pooled tensor is {tuple(q.shape)}, not "
                             f"{(b, t // wt, f // wf, c)}")
    return b * t * f, c, t, f, wt, wf


def _pool_apply_cuda(x, sums, scale, bias, n, eps, dtype, window):
    b, t, f, c = x.shape
    shape = (b, t // window[0], f // window[1], c)
    p = torch.empty(shape, dtype=dtype, device=x.device)
    count = torch.empty(shape, dtype=torch.uint8, device=x.device)
    geometry = _pool_check(x, window, p, count)
    _f32(sums, 2, c, "sums")
    scale, bias = _params(c, x.device, scale, bias)
    moments = torch.empty((3, c), dtype=torch.float32, device=x.device)
    kernels.launch(_POOL_KERNEL, _library().seld_batch_norm_pool_apply,
                   "batch_norm_pool_apply launch", x.get_device(),
                   x.data_ptr(), _is_bf16(x), p.data_ptr(), _is_bf16(p),
                   count.data_ptr(), *geometry,
                   _vec(x.view(-1, c), p, count), sums.data_ptr(),
                   scale.data_ptr(), bias.data_ptr(), _is_bf16(scale),
                   float(n), float(eps), moments.data_ptr())
    return p, count, moments


def _pool_grads_check(x, p, moments, scale, bias, window, like_p, *pooled):
    """The backward passes' operands: p, `like_p` in p's dtype and the
    other pooled tensors beside x; -> (geometry, (scale, bias))."""
    if like_p.dtype != p.dtype:
        raise ValueError(f"a pooled tensor is {like_p.dtype}, p {p.dtype}")
    geometry = _pool_check(x, window, p, like_p, *pooled)
    _f32(moments, 3, x.shape[-1], "moments")
    return geometry, _params(x.shape[-1], x.device, scale, bias)


def _pool_grad_sums_cuda(x, p, dp, count, moments, scale, bias, window):
    if count.dtype != torch.uint8:
        raise ValueError(f"count must be uint8; got {count.dtype}")
    geometry, (scale, bias) = _pool_grads_check(x, p, moments, scale, bias,
                                                window, dp, count)
    x2 = x.view(-1, x.shape[-1])
    vec = _vec(x2, p, dp, count)
    blocks, partial = _partials(x2, vec)
    dsums = torch.empty((2, x2.shape[1]), dtype=torch.float32,
                        device=x.device)
    share = torch.empty_like(p)
    kernels.launch(_POOL_KERNEL, _library().seld_batch_norm_pool_grad_sums,
                   "batch_norm_pool_grad_sums launch", x.get_device(),
                   x.data_ptr(), _is_bf16(x), p.data_ptr(), dp.data_ptr(),
                   _is_bf16(p), count.data_ptr(), share.data_ptr(),
                   *geometry, vec, blocks, moments.data_ptr(),
                   scale.data_ptr(), bias.data_ptr(), _is_bf16(scale),
                   partial.data_ptr(), dsums.data_ptr())
    return dsums, share


def _pool_grad_apply_cuda(x, p, share, moments, scale, bias, window, dsums,
                          n):
    geometry, (scale, bias) = _pool_grads_check(x, p, moments, scale, bias,
                                                window, share)
    _f32(dsums, 2, x.shape[-1], "dsums")
    dx = torch.empty_like(x)
    kernels.launch(_POOL_KERNEL, _library().seld_batch_norm_pool_grad_apply,
                   "batch_norm_pool_grad_apply launch", x.get_device(),
                   x.data_ptr(), _is_bf16(x), p.data_ptr(), share.data_ptr(),
                   _is_bf16(p), dx.data_ptr(), *geometry,
                   _vec(x.view(-1, x.shape[-1]), p, share, dx),
                   moments.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                   _is_bf16(scale), dsums.data_ptr(), float(n))
    return dx


def _on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (the twins), False for a CUDA one (the
    kernels); raises for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"batch_norm runs on cpu or cuda, not {x.device}")
    return x.device.type == "cpu"


def batch_norm_stats(x: torch.Tensor) -> torch.Tensor:
    """Pass 1: [sum x, sum x^2] of x [rows, C], [2, C] f32."""
    return batch_norm_stats_ref(x) if _on_cpu(x) else _stats_cuda(x)


def batch_norm_apply(x, sums, scale, bias, n, eps, dtype):
    """Pass 2: (y [rows, C] in `dtype`, moments [3, C] f32 = [mean, var,
    inv]) from pass 1's sums (the global batch's under data parallelism)
    over n rows."""
    fn = batch_norm_apply_ref if _on_cpu(x) else _apply_cuda
    return fn(x, sums, scale, bias, n, eps, dtype)


def batch_norm_grad_sums(x, dy, moments):
    """Pass 3: [sum dy, sum dy * xhat] of x, dy [rows, C], [2, C] f32."""
    fn = batch_norm_grad_sums_ref if _on_cpu(x) else _grad_sums_cuda
    return fn(x, dy, moments)


def batch_norm_grad_apply(x, dy, moments, scale, dsums, n):
    """Pass 4: dx [rows, C] in x's dtype from pass 3's sums (the global
    batch's under data parallelism) over n rows."""
    fn = batch_norm_grad_apply_ref if _on_cpu(x) else _grad_apply_cuda
    return fn(x, dy, moments, scale, dsums, n)


def batch_norm_pool_apply(x, sums, scale, bias, n, eps, dtype, window):
    """Pass 2': (the pooled max of relu(y) [B, T / wt, F / wf, C] in
    `dtype`, the count of each window's elements equal to it [same] uint8,
    moments [3, C] f32) of x [B, T, F, C] from pass 1's sums over n rows."""
    fn = batch_norm_pool_apply_ref if _on_cpu(x) else _pool_apply_cuda
    return fn(x, sums, scale, bias, n, eps, dtype, window)


def batch_norm_pool_grad_sums(x, p, dp, count, moments, scale, bias, window):
    """Pass 3': ([sum dy, sum dy * xhat] [2, C] f32, each pooled element's
    share [like p]), dy routed from the pooled p, its cotangent dp and the
    counts."""
    fn = batch_norm_pool_grad_sums_ref if _on_cpu(x) else \
        _pool_grad_sums_cuda
    return fn(x, p, dp, count, moments, scale, bias, window)


def batch_norm_pool_grad_apply(x, p, share, moments, scale, bias, window,
                               dsums, n):
    """Pass 4': dx [B, T, F, C] in x's dtype on the dy that pass 3' routed
    (its shares), from pass 3' sums (the global batch's under data
    parallelism) over n rows."""
    fn = batch_norm_pool_grad_apply_ref if _on_cpu(x) else \
        _pool_grad_apply_cuda
    return fn(x, p, share, moments, scale, bias, window, dsums, n)


def batch_norm_pool_applicable(shape, dtype, window) -> bool:
    """Where `batch_norm_relu_pool_train` applies: x [B, T, F, C] in f32 or
    bf16 whose C is a multiple of its 16-byte vector, a window that divides
    T and F and holds at most 255 elements (its count's byte), fewer than
    2^31 rows (the kernels' index range)."""
    if len(shape) != 4 or dtype not in (torch.float32, torch.bfloat16):
        return False
    b, t, f, c = shape
    wt, wf = window
    return (t % wt == 0 and f % wf == 0 and wt * wf <= 255
            and c % (16 // dtype.itemsize) == 0 and b * t * f < 2 ** 31)


# ---------------------------------------------------------------- autograd

def _statistics(ctx, x2):
    """Pass 1's sums of x2 [rows, C], all-reduced inside a data-parallel
    step; keeps on ctx whether it was one, its batch group and the global
    count n (read here: the backward may run on another thread, which does
    not see this thread's data-parallel step)."""
    sums = batch_norm_stats(x2)
    ctx.dp = collectives.active() is not None
    if ctx.dp:
        collectives.batch_reduce_(sums)
    ctx.group = collectives.batch_group()
    ctx.n = collectives.global_rows(x2.shape[0])
    return sums


def _global(ctx, dsums):
    """Pass 3's sums over the global batch: all-reduced over ctx's group
    inside a data-parallel step."""
    if ctx.dp:
        return collectives.all_reduce_(dsums.clone(), ctx.group)
    return dsums


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        c = x.shape[-1]
        x2 = x.contiguous().view(-1, c)
        sums = _statistics(ctx, x2)
        y, moments = batch_norm_apply(
            x2, sums, scale, bias, ctx.n, eps,
            torch.promote_types(x.dtype, scale.dtype))
        ctx.save_for_backward(x2, moments, scale)
        ctx.shape, ctx.dtypes = x.shape, (scale.dtype, bias.dtype)
        ctx.mark_non_differentiable(moments)
        return y.view(x.shape), moments

    @staticmethod
    def backward(ctx, dy, _dmoments):
        x2, moments, scale = ctx.saved_tensors
        dy2 = dy.contiguous().view(x2.shape)
        dsums = batch_norm_grad_sums(x2, dy2, moments)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = batch_norm_grad_apply(x2, dy2, moments, scale,
                                       _global(ctx, dsums),
                                       ctx.n).view(ctx.shape)
        return dx, dsums[1].to(ctx.dtypes[0]), dsums[0].to(ctx.dtypes[1]), \
            None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm of x [..., C] with the batch's statistics:
    (y like x in promote_types(x, scale), moments [3, C] f32 = [mean, var,
    inv], which carry no gradient and feed the running statistics)."""
    return _BatchNormTrain.apply(x, scale, bias, float(eps))


class _BatchNormReluPoolTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps, window):
        x = x.contiguous()
        sums = _statistics(ctx, x.view(-1, x.shape[-1]))
        p, count, moments = batch_norm_pool_apply(
            x, sums, scale, bias, ctx.n, eps,
            torch.promote_types(x.dtype, scale.dtype), window)
        ctx.save_for_backward(x, p, count, moments, scale, bias)
        ctx.window, ctx.dtypes = window, (scale.dtype, bias.dtype)
        ctx.mark_non_differentiable(moments)
        return p, moments

    @staticmethod
    def backward(ctx, dp, _dmoments):
        x, p, count, moments, scale, bias = ctx.saved_tensors
        dp = dp.contiguous()
        dsums, share = batch_norm_pool_grad_sums(x, p, dp, count, moments,
                                                 scale, bias, ctx.window)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = batch_norm_pool_grad_apply(x, p, share, moments, scale, bias,
                                            ctx.window, _global(ctx, dsums),
                                            ctx.n)
        return dx, dsums[1].to(ctx.dtypes[0]), dsums[0].to(ctx.dtypes[1]), \
            None, None


def batch_norm_relu_pool_train(x: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, eps: float, window
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """max_pool(relu(BatchNorm(x)), window, strides=window) of x [B, T, F,
    C] in training, the batch's statistics: (pooled [B, T / wt, F / wf, C]
    in promote_types(x, scale), moments [3, C] f32 as `batch_norm_train`'s).
    Where `batch_norm_pool_applicable` holds."""
    return _BatchNormReluPoolTrain.apply(x, scale, bias, float(eps),
                                         tuple(window))
