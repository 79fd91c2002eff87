"""Primitive layers (seld_tpu/models/layers.py) as torch nn.Modules.

Parameters keep flax's names and shapes — conv kernels HWIO ([*k, in/groups,
out]), Dense [I, O], MHA [H, I, S] / [H, S, O] (relative-position MHA adds
pos_kernel [H, P, S] and pos_bias_u/v [H, S]), the RFF encoding's w
[1, 1, d/2], GRU kernel [D, I, 3U], recurrent_kernel [D, U, 3U], bias
[D, 2, 3U], LSTM kernel [D, I, 4U], recurrent_kernel [D, U, 4U], bias
[D, 4U], BatchNorm scale/bias plus the running mean/var as buffers — and
every child module is registered under
flax's auto-name `<Class>_<n>` (`add_child`). A flax variable tree then maps
onto `state_dict()` by joining its path with "." (seld_tpu_torch.bridge).
Convs permute their kernel to OIHW at call time.

Activations stay channels-last ([B, T, F, C] / [B, T, D]), the JAX package's
layout. Modules are built for a known per-sample input shape (batch
excluded) and expose `out_shape`, the way flax infers shapes at init.

Keras-default initialisation from an explicit `torch.Generator`:
glorot-uniform kernels, orthogonal recurrent kernels, zero biases,
BatchNorm scale 1 (momentum 0.99, eps 1e-3).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from seld_tpu_torch.ops.batch_norm import (batch_norm_pool_applicable,
                                           batch_norm_relu_pool_train,
                                           batch_norm_train)
from seld_tpu_torch.ops.dropout import dropout, keep_mask
from seld_tpu_torch.parallel import collectives
from seld_tpu_torch.ops.gru import (gru_forward, in_scan_order,
                                   input_projection)
from seld_tpu_torch.ops.pooling import max_pool
from seld_tpu_torch.ops.stem import conv_bn_relu_pool, fused_stem_applicable


# ---------------------------------------------------------------- helpers

def add_child(parent: nn.Module, child: nn.Module,
              name: Optional[str] = None) -> nn.Module:
    """Register `child` under `name` or flax's auto-name `<Class>_<n>`
    (n counts the parent's earlier children of the same class).

    Parents keep further references to their children in plain lists,
    tuples or dicts, which nn.Module does not register a second time."""
    if name is None:
        kind = type(child).__name__
        n = sum(1 for k in parent._modules if k.rsplit("_", 1)[0] == kind)
        name = f"{kind}_{n}"
    parent.add_module(name, child)
    return child


def glorot_uniform(shape: Sequence[int], generator: torch.Generator,
                   batch_axis: Tuple[int, ...] = ()) -> torch.Tensor:
    """flax `glorot_uniform` (fan_avg uniform; in axis -2, out axis -1)."""
    shape = tuple(shape)
    nd = len(shape)
    skip = {nd - 2, nd - 1} | {a % nd for a in batch_axis}
    receptive = math.prod(s for i, s in enumerate(shape) if i not in skip)
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def orthogonal(shape: Sequence[int], generator: torch.Generator
               ) -> torch.Tensor:
    """flax `orthogonal` (column axis -1) from a torch generator."""
    shape = tuple(shape)
    n_rows, n_cols = math.prod(shape[:-1]), shape[-1]
    mat_shape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
    a = torch.randn(mat_shape, generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape).float()


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator()


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA "SAME": out = ceil(size / s), the total pad split with the
    smaller half first — asymmetric for even totals (strided convs,
    even kernels)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def get_activation(name: Optional[Union[str, Callable]]
                   ) -> Optional[Callable]:
    """Keras-style activation-name resolution."""
    if name is None or callable(name):
        return name
    table = {
        "relu": torch.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "swish": F.silu,
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
        "elu": F.elu,
        "softmax": lambda x: torch.softmax(x, dim=-1),
        "linear": None,
    }
    if name not in table:
        raise ValueError(f"unknown activation: {name!r}")
    return table[name]


def merge_bidirectional(fwd, bwd, merge_mode: str):
    """Bidirectional RNN merge (Keras Bidirectional merge_mode semantics)."""
    if merge_mode == "mul":
        return fwd * bwd
    if merge_mode == "concat":
        return torch.cat([fwd, bwd], dim=-1)
    if merge_mode in ("ave", "avg"):
        return (fwd + bwd) * 0.5
    if merge_mode == "sum":
        return fwd + bwd
    raise ValueError(f"unknown merge_mode: {merge_mode!r}")


def force_1d(x: torch.Tensor) -> torch.Tensor:
    """[B, T, F, C] -> [B, T, F*C]; passthrough for 3D (layers.py:41-47)."""
    if x.dim() == 4:
        return x.reshape(x.shape[0], x.shape[1], x.shape[2] * x.shape[3])
    return x


def force_1d_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """Per-sample shape after `force_1d`."""
    shape = tuple(shape)
    return (shape[0], shape[1] * shape[2]) if len(shape) == 3 else shape


def basic_pos_encoding(time: int, d_model: int) -> torch.Tensor:
    """Sinusoidal encoding [1, time, d_model], cos/sin interleaved."""
    k = d_model // 2
    w = np.power(10000.0, -np.arange(k) / k)[None, :]
    t = np.arange(time, dtype=np.float64)[:, None]
    enc = np.stack([np.cos(w * t), np.sin(w * t)], axis=-1)
    return torch.from_numpy(enc.reshape(1, time, 2 * k).astype(np.float32))


@functools.lru_cache(maxsize=None)
def basic_pos_encoding_on(time: int, d_model: int, device: torch.device,
                          dtype: torch.dtype) -> torch.Tensor:
    """`basic_pos_encoding` on `device` in `dtype`, made once: a forward
    that adds it makes no host-to-device copy, which the capture of a CUDA
    graph refuses. Made outside inference mode, so that a training step can
    save it for backward (relative-position attention does) after an
    inference forward made it first. Callers must not write into it."""
    with torch.inference_mode(False):
        return basic_pos_encoding(time, d_model).to(device=device,
                                                    dtype=dtype)


# ---------------------------------------------------------------- layers

class RFFPosEncoding(nn.Module):
    """Random-Fourier-feature encoding [1, time, d_model]: cos and sin of
    w * t, concatenated. `w` [1, 1, d_model // 2] ~ N(0, 1) is a parameter
    that the forward reads detached, as JAX's stop_gradient: no gradient
    reaches it (the train step gives it zeros, as jax.grad does), so no
    optimizer moves it."""

    unused_parameters = ("w",)

    def __init__(self, d_model: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.Parameter(torch.randn(
            (1, 1, d_model // 2), generator=_generator(generator)))

    def forward(self, time: int, dtype: torch.dtype) -> torch.Tensor:
        w = self.w.detach().to(dtype)
        t = torch.arange(time, device=w.device, dtype=dtype).reshape(1, -1, 1)
        return torch.cat([torch.cos(w * t), torch.sin(w * t)], dim=-1)


class Conv(nn.Module):
    """Channels-last 1D/2D conv; parameters `kernel` [*k, in/groups, out]
    and `bias` [out], padding computed as XLA's "SAME" or "VALID" on the
    dilated kernel (`kernel_dilation`, flax nn.Conv's)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, ...],
                 strides: Optional[Tuple[int, ...]] = None,
                 padding: str = "SAME", feature_group_count: int = 1,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 kernel_dilation: Optional[Tuple[int, ...]] = None):
        super().__init__()
        g = _generator(generator)
        self.kernel_size = tuple(kernel_size)
        self.strides = (tuple(strides) if strides
                        else (1,) * len(self.kernel_size))
        self.dilation = (tuple(kernel_dilation) if kernel_dilation
                         else (1,) * len(self.kernel_size))
        # the extent of each dilated kernel, which the padding sees
        self.span = tuple((k - 1) * d + 1 for k, d in
                          zip(self.kernel_size, self.dilation))
        self.padding = padding.upper()
        if self.padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        self.groups = feature_group_count
        self.features = features
        self.kernel = nn.Parameter(glorot_uniform(
            (*self.kernel_size, in_features // self.groups, features), g))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def out_shape_of(self, in_shape: Sequence[int]) -> Tuple[int, ...]:
        *spatial, _ = in_shape
        if self.padding == "SAME":
            spatial = [-(-n // s) for n, s in zip(spatial, self.strides)]
        else:
            spatial = [(n - k) // s + 1 for n, k, s in
                       zip(spatial, self.span, self.strides)]
        return (*spatial, self.features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        if self.kernel.shape[-1] != self.features:
            return self._sharded(x.to(dt), dt)
        return self._conv(x.to(dt), self.kernel.to(dt), self.bias,
                          self.groups)

    def _sharded(self, x: torch.Tensor, dt) -> torch.Tensor:
        """The kernel is this rank's shard of the output channels (tensor
        parallelism, parallel/collectives.py): this rank's channels from
        the whole input (a grouped conv's from its groups' inputs), put
        back together, then the bias."""
        index, size = collectives.shard_index()
        groups = self.groups
        x = collectives.enter_shards(x)
        if groups > 1:
            if groups % size:
                raise ValueError(f"a conv of {groups} groups does not "
                                 f"shard over {size} ranks")
            n = x.shape[-1] // size
            x = x.narrow(-1, index * n, n)
            groups //= size
        y = collectives.gather_shards(self._conv(
            x, self.kernel.to(dt), None, groups))
        return y + self.bias.to(dt) if self.bias is not None else y

    def _conv(self, x, kernel, bias, groups) -> torch.Tensor:
        dt = x.dtype
        nsp = len(self.kernel_size)
        x = x.movedim(-1, 1)                        # channels first
        if self.padding == "SAME":
            pads = []
            for i in reversed(range(nsp)):          # F.pad: last dim first
                pads += same_padding(x.shape[2 + i], self.span[i],
                                     self.strides[i])
            if any(pads):
                x = F.pad(x, pads)
        w = kernel.permute(nsp + 1, nsp, *range(nsp))   # OI(H)W
        b = bias.to(dt) if bias is not None else None
        conv = F.conv2d if nsp == 2 else F.conv1d
        y = conv(x, w, b, stride=self.strides, dilation=self.dilation,
                 groups=groups)
        return y.movedim(1, -1)


class BatchNorm(nn.Module):
    """BatchNorm with Keras defaults (momentum 0.99, epsilon 1e-3) over the
    last axis: f32 math, result cast back to the promoted input/param dtype.
    Training mode uses biased batch statistics and updates the running
    stats as ra = m * ra + (1 - m) * batch; it runs as
    `ops.batch_norm.batch_norm_train`, the hand-written passes of
    csrc/batch_norm.cu on the card and their plain twins on the CPU. Inside
    a data-parallel step (parallel/collectives.py) the statistics are the
    global batch's: the sums of x and x^2 are all-reduced, E[x^2] - E[x]^2
    over the global count.

    With `relu_pool`, a window [wt, wf], the result of x [B, T, F, C] goes
    on through ReLU and a VALID max pool with strides equal to the window.
    In training, where `batch_norm_pool_applicable` holds (the window
    divides T and F, C a multiple of x's 16-byte vector), the three run as
    one autograd Function, `ops.batch_norm.batch_norm_relu_pool_train`,
    which writes only the pooled tensor and equals the composed chain bit
    for bit; eval mode and other shapes compose them."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-3):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                relu_pool: Optional[Sequence[int]] = None) -> torch.Tensor:
        if relu_pool is not None:
            window = tuple(relu_pool)
            if self.training and batch_norm_pool_applicable(
                    x.shape, x.dtype, window):
                pooled, moments = batch_norm_relu_pool_train(
                    x, self.scale, self.bias, self.epsilon, window)
                self.update_running(moments[0], moments[1])
                return pooled
            return max_pool(torch.relu(self.forward(x)), window,
                            strides=window)
        if self.training:
            y, moments = batch_norm_train(x, self.scale, self.bias,
                                          self.epsilon)
            self.update_running(moments[0], moments[1])
            return y
        out_dtype = torch.promote_types(x.dtype, self.scale.dtype)
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale.float()
        y = (x.float() - self.mean) * inv + self.bias.float()
        return y.to(out_dtype)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """ra = m * ra + (1 - m) * batch, for the running mean and var."""
        m = self.momentum
        self.mean.mul_(m).add_((1 - m) * mean)
        self.var.mul_(m).add_((1 - m) * var)


class Conv2DBN(nn.Module):
    """Conv2D + BatchNorm + activation, then (with `pool`) a VALID
    non-overlapping max pool — the conv_temporal stem.

    In training, with a pool and a conv bias, where `fused_stem_applicable`
    holds (ReLU, SAME, unit stride, no groups, T and F divisible by the
    pool), the whole block runs as `ops.stem.conv_bn_relu_pool` — the fused
    op whose backward is the stem_dy kernel on the card — and BatchNorm_0's
    running statistics follow from its batch mean and variance
    (seld_tpu/models/layers.py:224-236). Eval and other shapes compose the
    layers."""

    def __init__(self, in_shape: Sequence[int], filters: int,
                 kernel_size: Union[int, Tuple[int, int]],
                 strides: Union[int, Tuple[int, int]] = (1, 1),
                 padding: str = "SAME", groups: int = 1,
                 use_bias: bool = True, activation: Optional[str] = "relu",
                 pool: Optional[Tuple[int, int]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ks = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        st = (strides,) * 2 if isinstance(strides, int) else tuple(strides)
        conv = add_child(self, Conv(
            in_shape[-1], filters, ks, strides=st, padding=padding,
            feature_group_count=groups, use_bias=use_bias,
            generator=generator))
        add_child(self, BatchNorm(filters))
        self.activation = activation
        self.act = get_activation(activation)
        self.pool = tuple(pool) if pool is not None else None
        t, f, c = conv.out_shape_of(in_shape)
        if self.pool is not None:
            t, f = t // self.pool[0], f // self.pool[1]
        self.out_shape = (t, f, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.Conv_0, self.BatchNorm_0
        if self.training and conv.bias is not None and fused_stem_applicable(
                x.shape, self.pool, conv.strides, conv.padding, conv.groups,
                self.activation):
            dt = torch.promote_types(x.dtype, conv.kernel.dtype)
            x, bias, gamma, beta = x.to(dt), conv.bias, bn.scale, bn.bias
            sharded = conv.kernel.shape[-1] != conv.features
            if sharded:
                # this rank's filters (tensor parallelism): their own
                # statistics, stem_dy on this rank's channels
                x = collectives.enter_shards(x)
                bias, gamma, beta = (collectives.take_shard(t)
                                     for t in (bias, gamma, beta))
            pooled, mean, var = conv_bn_relu_pool(
                x, conv.kernel.to(dt), bias.to(dt), gamma, beta, self.pool,
                bn.epsilon)
            if sharded:
                pooled = collectives.gather_shards(pooled)
                with torch.no_grad():
                    mean, var = (collectives.gather_shards(t)
                                 for t in (mean, var))
            bn.update_running(mean, var)
            return pooled
        x = bn(conv(x))
        if self.act:
            x = self.act(x)
        if self.pool is not None:
            x = max_pool(x, self.pool, strides=self.pool, padding="VALID")
        return x


class Dense(nn.Module):
    """flax `nn.Dense`: `kernel` [I, O] (glorot uniform), `bias` [O]."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.kernel = nn.Parameter(
            glorot_uniform((in_features, features), _generator(generator)))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        kernel = self.kernel.to(dt)
        if kernel.shape[-1] == self.features:
            y = x.to(dt) @ kernel
        else:
            # this rank's columns (tensor parallelism), put back together
            y = collectives.gather_shards(
                collectives.enter_shards(x.to(dt)) @ kernel)
        return y + self.bias.to(dt) if self.bias is not None else y


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis: f32 statistics with the fast
    variance E[x^2] - E[x]^2 (clamped at 0), `scale`/`bias` params."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0)
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale)
        return (y + self.bias).to(torch.promote_types(x.dtype,
                                                    self.scale.dtype))


class MultiHeadAttention(nn.Module):
    """MHA with per-head Q/K/V kernels [H, I, S] and projection [H, S, O];
    the query is pre-scaled by 1/sqrt(S) before the logits product."""

    def __init__(self, query_features: int, key_features: int,
                 value_features: int, num_heads: int, head_size: int,
                 output_size: Optional[int] = None, dropout: float = 0.0,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        h, s = num_heads, head_size
        out = output_size or value_features
        self.num_heads, self.head_size, self.dropout = h, head_size, dropout
        self.dropout_generator = None   # set_dropout_generator
        self.query_kernel = nn.Parameter(glorot_uniform((h, query_features, s), g))
        self.key_kernel = nn.Parameter(glorot_uniform((h, key_features, s), g))
        self.value_kernel = nn.Parameter(glorot_uniform((h, value_features, s), g))
        self.projection_kernel = nn.Parameter(glorot_uniform((h, s, out), g))
        self.use_bias = use_bias
        if use_bias:
            self.q_bias = nn.Parameter(torch.zeros(h, s))
            self.k_bias = nn.Parameter(torch.zeros(h, s))
            self.v_bias = nn.Parameter(torch.zeros(h, s))
            self.projection_bias = nn.Parameter(torch.zeros(out))

    @property
    def _sharded(self) -> bool:
        """The head kernels hold this rank's heads (tensor parallelism,
        parallel/collectives.py)."""
        return self.query_kernel.shape[0] != self.num_heads

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's heads of a replicated per-head leaf [H, ...]."""
        return collectives.take_shard(t) if self._sharded else t

    def _qkv(self, query, key, value):
        if self._sharded:
            # one gradient sum an input, also where query is key is value
            entered = {}
            for t in (query, key, value):
                if id(t) not in entered:
                    entered[id(t)] = collectives.enter_shards(t)
            query, key, value = (entered[id(t)] for t in (query, key, value))
        q = torch.einsum("...ni,hio->...hno", query, self.query_kernel)
        k = torch.einsum("...mi,hio->...hmo", key, self.key_kernel)
        v = torch.einsum("...mi,hio->...hmo", value, self.value_kernel)
        if self.use_bias:
            q = q + self._heads(self.q_bias)[:, None]
            k = k + self._heads(self.k_bias)[:, None]
            v = v + self._heads(self.v_bias)[:, None]
        return q, k, v

    def forward(self, query, key, value):
        q, k, v = self._qkv(query, key, value)
        q = q / math.sqrt(self.head_size)
        logits = torch.einsum("...hno,...hmo->...hnm", q, k)
        return self._attend(logits, v)

    def _attend(self, logits, v):
        attn = torch.softmax(logits, dim=-1)
        sharded = self._sharded
        attn = dropout(attn, self.dropout, self.training,
                       self.dropout_generator,
                       shard_dim=-3 if sharded else None)
        out = torch.einsum("...hnm,...hmi->...hni", attn, v)
        out = torch.einsum("...hni,hio->...no", out, self.projection_kernel)
        if sharded:
            out = collectives.reduce_shards(out)    # the other ranks' heads
        if self.use_bias:
            out = out + self.projection_bias
        return out


class RelPositionMultiHeadAttention(MultiHeadAttention):
    """Transformer-XL-style relative-position MHA: forward(query, key,
    value, pos) with pos [1, T_pos, P]. Logits = (q + u)·k +
    rel_shift((q + v)·(pos W_pos)), scaled by 1/sqrt(S) after the sum
    (the absolute MHA scales the query before its product); the shifted
    term keeps its first M key columns."""

    def __init__(self, query_features: int, key_features: int,
                 value_features: int, pos_features: int, num_heads: int,
                 head_size: int, output_size: Optional[int] = None,
                 dropout: float = 0.0, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        g = _generator(generator)
        super().__init__(query_features, key_features, value_features,
                         num_heads, head_size, output_size, dropout,
                         use_bias, g)
        h, s = num_heads, head_size
        self.pos_kernel = nn.Parameter(glorot_uniform((h, pos_features, s),
                                                      g))
        self.pos_bias_u = nn.Parameter(glorot_uniform((h, s), g))
        self.pos_bias_v = nn.Parameter(glorot_uniform((h, s), g))

    @staticmethod
    def relative_shift(x: torch.Tensor) -> torch.Tensor:
        """[B, H, N, M] -> shifted so diagonal indexing becomes relative."""
        b, h, n, m = x.shape
        x = F.pad(x, (1, 0)).reshape(b, h, m + 1, n)
        return x[:, :, 1:, :].reshape(b, h, n, m)

    def forward(self, query, key, value, pos):
        q, k, v = self._qkv(query, key, value)
        if self._sharded:
            pos = collectives.enter_shards(pos)
        p = torch.einsum("...mi,hio->...hmo", pos, self.pos_kernel)
        logits_u = torch.einsum("...hno,...hmo->...hnm",
                                q + self._heads(self.pos_bias_u)[:, None], k)
        logits_v = torch.einsum("...hno,...hmo->...hnm",
                                q + self._heads(self.pos_bias_v)[:, None], p)
        logits_v = self.relative_shift(logits_v)
        logits = logits_u + logits_v[..., :logits_u.shape[-1]]
        return self._attend(logits / math.sqrt(self.head_size), v)


class GRU(nn.Module):
    """(Bi)directional GRU over [B, T, I] -> [B, T, U*dirs or U].

    Keras GRU v2 semantics (reset_after, z|r|h): kernel [D, I, 3U],
    recurrent_kernel [D, U, 3U], bias [D, 2, 3U]. `ops.gru.gru_route`
    picks the recurrence: `ops.gru.gru_scan` where the kernels take U (the
    CUDA kernels on the card, their plain versions on the CPU), else the
    plain recurrence under torch's autograd where the JAX layer runs
    `lax.scan` too; on the card it raises where the JAX layer runs a Pallas
    kernel that the port lacks. Direction 1 runs in descending time with
    its states at their real t, which equals the JAX scan path's
    reverse-and-flip.

    Dropout in training follows Keras implementation=1, as the JAX layer
    does: `dropout` draws one keep mask per gate, direction and batch row
    over the input features ([D, 3, B, 1, I], constant over time) and
    applies it to that gate's input projection, which `gru_scan` then
    runs; `recurrent_dropout` draws masks [D, 3, B, U] for h_{t-1} inside
    the step, which takes the "masked" route (a plain recurrence, as the
    JAX layer leaves its kernel for `lax.scan`). Masks come from
    `dropout_generator` (set_dropout_generator).
    """

    n_gates = 3

    def __init__(self, in_features: int, units: int,
                 bidirectional: bool = False, merge_mode: str = "mul",
                 dropout: float = 0.0, recurrent_dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = _generator(generator)
        dirs = 2 if bidirectional else 1
        self.units, self.bidirectional = units, bidirectional
        self.merge_mode = merge_mode
        self.dropout, self.recurrent_dropout = dropout, recurrent_dropout
        self.dropout_generator = None   # set_dropout_generator
        k = self.n_gates * units
        # per-direction glorot fans ([I, kU]), as Keras Bidirectional
        self.kernel = nn.Parameter(glorot_uniform(
            (dirs, in_features, k), g, batch_axis=(0,)))
        self.recurrent_kernel = nn.Parameter(orthogonal((dirs, units, k), g))
        self.bias = nn.Parameter(self._initial_bias(dirs, units))

    @staticmethod
    def _initial_bias(dirs: int, units: int) -> torch.Tensor:
        return torch.zeros(dirs, 2, 3 * units)

    def _masks(self, x: torch.Tensor, dtype: torch.dtype):
        """(gate_masks [D, G, B, 1, I] or None, rec_masks [D, G, B, U] or
        None) for this call, the input's first (the JAX layer's order)."""
        dirs, g = self.kernel.shape[0], self.n_gates
        gate_masks = rec_masks = None
        if self.training and self.dropout > 0.0:
            # the batch at dim 2 of both masks (keep_mask's batch_dim)
            gate_masks = keep_mask((dirs, g, x.shape[0], 1, x.shape[-1]),
                                   1.0 - self.dropout,
                                   self.dropout_generator, x.device, dtype,
                                   2)
        if self.training and self.recurrent_dropout > 0.0:
            rec_masks = keep_mask((dirs, g, x.shape[0], self.units),
                                  1.0 - self.recurrent_dropout,
                                  self.dropout_generator, x.device, dtype,
                                  2)
        return gate_masks, rec_masks

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        gate_masks, rec_masks = self._masks(x, dt)
        return gru_forward(x, self.kernel, self.recurrent_kernel, self.bias,
                           bidirectional=self.bidirectional,
                           merge_mode=self.merge_mode,
                           gate_masks=gate_masks, rec_masks=rec_masks)


def lstm_recurrence(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                    rec_masks: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The LSTM recurrence (Keras gate order i|f|c|o) under torch's
    autograd, both directions a step, f32 gate math: x_proj [D, T, B, 4U]
    (input projection and bias), rec_kernel [D, U, 4U], rec_masks
    [D, 4, B, U] or None -> hs [D, T, B, U] in x_proj's dtype; d=1 runs in
    descending time with its states at their real t. The JAX package
    composes it with `lax.scan` and has no kernel for it."""
    d_dirs, t_steps, b, k = x_proj.shape
    u = k // 4
    rk = rec_kernel.float()
    xs = in_scan_order(x_proj)
    h = x_proj.new_zeros((d_dirs, b, u), dtype=torch.float32)
    c = torch.zeros_like(h)
    hs = []
    for p in range(t_steps):
        if rec_masks is None:
            hp = torch.bmm(h, rk)
        else:
            hp = torch.einsum("dgbu,dugk->dbgk",
                              h[:, None] * rec_masks.float(),
                              rk.reshape(d_dirs, u, 4, u)).reshape(
                                  d_dirs, b, k)
        gi, gf, gc, go = (xs[:, p].float() + hp).split(u, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gc)
        h = torch.sigmoid(go) * torch.tanh(c)
        hs.append(h)
    return in_scan_order(torch.stack(hs, dim=1)).to(x_proj.dtype)


class LSTM(GRU):
    """(Bi)directional LSTM over [B, T, I], Keras gate order (i|f|c|o):
    kernel [D, I, 4U] (per-direction glorot fans), recurrent_kernel
    [D, U, 4U] (orthogonal), bias [D, 4U] with the unit forget bias. The
    recurrence is `lstm_recurrence` on every device (the JAX package
    composes it too). Dropout as GRU's, with 4 gates."""

    n_gates = 4

    @staticmethod
    def _initial_bias(dirs: int, units: int) -> torch.Tensor:
        bias = torch.zeros(dirs, 4 * units)
        bias[:, units:2 * units] = 1.0
        return bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        gate_masks, rec_masks = self._masks(x, dt)
        x_proj = input_projection(x, self.kernel, self.bias, gate_masks)
        hs = lstm_recurrence(x_proj, self.recurrent_kernel.to(dt),
                             rec_masks).transpose(1, 2)     # [D, B, T, U]
        if not self.bidirectional:
            return hs[0]
        return merge_bidirectional(hs[0], hs[1], self.merge_mode)
