"""Train-mode BatchNorm as four passes (seld_tpu_torch/ops/batch_norm.py,
csrc/batch_norm.cu) against the composed train-mode BatchNorm the port ran
before them, kept here as the oracle: the f32 steps of
models/layers.py's BatchNorm (a copy of x in f32, two means, the biased
E[x^2] - E[x]^2, the normalise, the cast back) under autograd.

On the CPU the passes run their plain twins, so these tests hold the
autograd Function's logic: the output, the running statistics, and the
gradients of x, scale and bias, in f32 and bf16, at C in {3, 32, 64, 96,
192} (C = 3 takes the kernels' one-channel-a-thread plan) and row counts
that no block step divides. Also: the twins' sums in the kernels' order
against exact sums; the fused stem's statistics against the formula it
had; a step on two gloo ranks (this file run as a script: one group of two
CPU ranks), each holding half the batch, against one process over the
whole batch, with the backward on another thread than the forward.

Tolerances. f32: the output, the running statistics and the gradients to
1e-5 of their largest element. The two sides add their sums in other
orders, and E[x^2] - E[x]^2 cancels: at channel offsets up to 6 spreads
(E[x^2] / var up to ~50) the variance's rounding reaches ~50 f32 steps,
and the output's with it (5e-6 seen); the composed backward reaches x
through E[x^2] and E[x]^2 separately, the passes through x - mean. bf16:
the output and dx to one bf16 step (2^-7) of their largest element: both sides round
an f32 value to bf16 once, and their f32 values differ by f32 rounding;
dscale and dbias, f32 sums of bf16 cotangents, to 1e-4.

The fused BatchNorm -> ReLU -> max pool (`batch_norm_relu_pool_train`,
`BatchNorm(x, relu_pool=...)`) runs its plain twins here, which spell out
the routing of the cotangent and add in the kernels' order: it must equal
the composed BatchNorm -> relu -> max_pool under autograd bit for bit, on
inputs with tied window maxima and windows all <= 0 after the affine.
"""
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = (3, 32, 64, 96, 192)
SHAPE = (3, 7, 5)          # 105 rows: no block step (R x 4 rows) divides it
EPS, MOMENTUM = 1e-3, 0.99


def composed_train(x, scale, bias, eps=EPS):
    """The composed train-mode BatchNorm (models/layers.py before the
    passes): (y, batch mean, batch var)."""
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dims)
    var = xf.square().mean(dims) - mean.square()
    out_dtype = torch.promote_types(x.dtype, scale.dtype)
    inv = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mean) * inv + bias.float()).to(out_dtype), mean, var


def _inputs(c, dtype, seed=0, shape=SHAPE):
    """x with a channel offset larger than its spread (the cancellation
    E[x^2] - E[x]^2 meets), scale, bias and a cotangent."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, c) * rng.uniform(0.5, 2, c) + rng.uniform(-3, 3, c)
    arrays = (x, 1 + 0.2 * rng.randn(c), 0.1 * rng.randn(c),
              rng.randn(*shape, c))
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


def _run(fn, x, scale, bias, cot):
    """(y, every gradient) of sum(fn(x) * cot) over leaves x, scale, bias."""
    x, scale, bias = (t.detach().requires_grad_(True)
                      for t in (x, scale, bias))
    y = fn(x, scale, bias)
    grads = torch.autograd.grad((y.float() * cot.float()).sum(),
                                (x, scale, bias))
    return y.detach(), grads


def _close(got, want, rel):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=rel * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", CHANNELS)
def test_function_matches_the_composed_batch_norm(c, dtype):
    from seld_tpu_torch.ops.batch_norm import batch_norm_train
    x, scale, bias, cot = _inputs(c, dtype)
    got_y, got_g = _run(lambda *a: batch_norm_train(*a, EPS)[0], x, scale,
                        bias, cot)
    want_y, want_g = _run(lambda *a: composed_train(*a)[0], x, scale, bias,
                          cot)
    assert got_y.dtype == want_y.dtype == dtype
    f32 = dtype == torch.float32
    _close(got_y, want_y, 1e-5 if f32 else 2 ** -7)
    for name, g, w, rel in zip(("dx", "dscale", "dbias"), got_g, want_g,
                               (1e-5 if f32 else 2 ** -7, 1e-4, 1e-4)):
        assert g.dtype == w.dtype, name
        _close(g, w, 1e-5 if f32 else rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", CHANNELS)
def test_module_running_statistics_match_the_composed_update(c, dtype):
    """BatchNorm in training mode: its output and its running mean and
    var after two steps, against the composed statistics' update."""
    from seld_tpu_torch.models.layers import BatchNorm
    bn = BatchNorm(c).train()
    x, scale, bias, _ = _inputs(c, dtype, seed=1)
    with torch.no_grad():
        bn.scale.copy_(scale.float())
        bn.bias.copy_(bias.float())
        bn.mean.uniform_(-1, 1)
        bn.var.uniform_(0.5, 2)
    mean, var = bn.mean.clone(), bn.var.clone()
    for step in range(2):
        xs = x * (1 + step)
        y = bn(xs)
        want_y, m, v = composed_train(xs, bn.scale, bn.bias)
        mean = MOMENTUM * mean + (1 - MOMENTUM) * m
        var = MOMENTUM * var + (1 - MOMENTUM) * v
        _close(y, want_y, 1e-5 if dtype == torch.float32 else 2 ** -7)
    _close(bn.mean, mean, 1e-5)
    _close(bn.var, var, 1e-5)


def test_eval_mode_is_the_composed_formula_bit_for_bit():
    from seld_tpu_torch.models.layers import BatchNorm
    bn = BatchNorm(32).eval()
    with torch.no_grad():
        bn.mean.uniform_(-1, 1)
        bn.var.uniform_(0.5, 2)
        bn.scale.uniform_(0.5, 1.5)
    x = _inputs(32, torch.bfloat16)[0]
    inv = torch.rsqrt(bn.var + bn.epsilon) * bn.scale.float()
    want = ((x.float() - bn.mean) * inv + bn.bias.float()).to(torch.float32)
    assert torch.equal(bn(x), want)


@pytest.mark.parametrize("c,dtype", [(3, torch.float32), (96, torch.bfloat16),
                                     (64, torch.float32)])
def test_ordered_sums_are_the_sums(c, dtype, monkeypatch):
    """The twins add in the kernels' order (csrc/batch_norm.cu's plan):
    equal to exact sums within f32 rounding, also where the blocks run
    out along the rows and each thread walks several block steps."""
    from seld_tpu_torch.ops import batch_norm as bn
    x = _inputs(c, dtype, seed=4, shape=(9, 13, 11))[0].reshape(-1, c)
    for blocks in (bn._MAX_BLOCKS, 3):
        monkeypatch.setattr(bn, "_MAX_BLOCKS", blocks)
        r, g = bn._plan(x.shape[0], c, bn._width(x, c))
        steps = -(-x.shape[0] // (g * r * 4))   # block steps a thread walks
        assert g <= blocks and (steps > 1) == (blocks == 3)
        sums = bn.batch_norm_stats_ref(x)
        xd = x.double()
        want = torch.stack([xd.sum(0), xd.square().sum(0)])
        torch.testing.assert_close(sums.double(), want, rtol=1e-6,
                                   atol=1e-6 * want.abs().max().item())


def test_plan_mirrors_the_kernel_source():
    """`_plan`'s constants are csrc/batch_norm.cu's."""
    from seld_tpu_torch.ops import batch_norm as bn
    from seld_tpu_torch.ops import kernels
    with open(os.path.join(kernels.CSRC_DIR, "batch_norm.cu")) as f:
        src = f.read()
    for name, value in (("kThreads", bn._THREADS), ("kUnroll", bn._UNROLL),
                        ("kMaxPartials", bn._MAX_BLOCKS),
                        ("kFinalRows", bn._LANES)):
        assert f"constexpr int {name} = {value};" in src, name
    assert bn._plan(256 * 300 * 64, 64, 8) == (32, 4096)      # SELDnet's
    assert bn._plan(256 * 60 * 11, 96, 8) == (21, 2012)       # SS5's stage


def test_kernels_name_the_new_source():
    from seld_tpu_torch.ops import kernels
    assert kernels.KERNELS["batch_norm"] == "batch_norm.cu"
    assert "batch_norm.cu" in kernels.SOURCES
    with open(os.path.join(kernels.CSRC_DIR, "batch_norm.cu")) as f:
        src = f.read()
    assert "Replaces no TPU kernel" in src and "seld_cuda_error_string" in src
    for name in ("stats", "apply", "grad_sums", "grad_apply"):
        assert f"batch_norm_{name}_kernel" in src


@pytest.mark.parametrize("kernel", [
    "void (anonymous namespace)::batch_norm_stats_kernel<__nv_bfloat16, 8>"
    "(__nv_bfloat16 const*, long long, int, int, int, float*)",
    "batch_norm_finalize_kernel(float const*, int, int, float*)",
    "batch_norm_apply_kernel<float, float, 4>",
    "batch_norm_grad_sums_kernel<__nv_bfloat16, __nv_bfloat16, 8>",
    "batch_norm_grad_apply_kernel<float, float, 1>",
    "void (anonymous namespace)::batch_norm_pool_apply_kernel<__nv_bfloat16,"
    " __nv_bfloat16, 8>(__nv_bfloat16 const*, __nv_bfloat16*, unsigned "
    "char*, int, int, int, int, (anonymous namespace)::Window, float const*, "
    "void const*, void const*, int, float, float, float*)",
    "void (anonymous namespace)::batch_norm_pool_share_kernel<__nv_bfloat16,"
    " 8>(__nv_bfloat16 const*, __nv_bfloat16 const*, unsigned char const*, "
    "long long, __nv_bfloat16*)",
    "batch_norm_pool_grad_sums_kernel<__nv_bfloat16, float, 8>",
    "batch_norm_pool_grad_apply_kernel<float, float, 4>"])
def test_trace_families_of_the_passes(kernel):
    """The port's grouping names the passes' kernels batch_norm; the
    benchmark's frozen classifier, which predates them, puts them in its
    "other" family, outside elementwise_ms.train."""
    from seld_bench.yardstick.trace import family
    from seld_tpu_torch.utils.trace_analysis import _classify
    assert _classify(kernel) == "batch_norm"
    assert family(kernel) == "other"


# ------------------------------------------ BatchNorm -> ReLU -> max pool

POOL_SHAPE = (3, 10, 8)    # [B, T, F]: 240 rows; windows of 20 and of 2


def _pool_inputs(c, dtype, window, seed=7):
    """x in quarter steps (windows with tied maxima), scale, bias with the
    first two channels at -3 (windows all <= 0 after the affine), a third
    channel constant with bias 0 (y exactly 0: a window's maximum 0 held
    by all its elements, which ReLU's backward stops) and a cotangent of
    the pooled shape."""
    rng = np.random.RandomState(seed)
    b, t, f = POOL_SHAPE
    x = np.round(rng.randn(b, t, f, c) * 4) / 4 + rng.uniform(-1, 1, c)
    x[..., 2] = 0.5
    bias = 0.1 * rng.randn(c)
    bias[:2] = -3
    bias[2] = 0
    dp = rng.randn(b, t // window[0], f // window[1], c)
    arrays = (x, 1 + 0.2 * rng.randn(c), bias, dp)
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


def _fused_and_composed(c, dtype, window):
    """(fused, composed): each (pooled, running mean, running var, dx,
    dscale, dbias) of BatchNorm in training with its parameters in `dtype`
    (as the train step's copies), the running statistics from seeded
    values after one step."""
    from seld_tpu_torch.models.layers import BatchNorm
    from seld_tpu_torch.ops.pooling import max_pool
    x, scale, bias, dp = _pool_inputs(c, dtype, window)
    out = []
    for fused in (True, False):
        bn = BatchNorm(c).train()
        with torch.no_grad():
            bn.mean.uniform_(-1, 1, generator=torch.Generator().manual_seed(1))
            bn.var.uniform_(0.5, 2, generator=torch.Generator().manual_seed(2))
        xg, s, b = (t.detach().clone().requires_grad_(True)
                    for t in (x, scale, bias))
        params = {"scale": s, "bias": b}
        if fused:
            p = torch.func.functional_call(bn, params, (xg,),
                                           {"relu_pool": window})
        else:
            y = torch.func.functional_call(bn, params, (xg,))
            p = max_pool(torch.relu(y), window, strides=window)
        grads = torch.autograd.grad((p.float() * dp.float()).sum(),
                                    (xg, s, b))
        out.append((p.detach(), bn.mean.clone(), bn.var.clone(), *grads))
    return out


@pytest.mark.parametrize("window", [(5, 4), (1, 2)], ids=["5x4", "1x2"])
@pytest.mark.parametrize("c", [64, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_pool_equals_the_composed_chain_bit_for_bit(dtype, c, window):
    """The Function's pooled output, running mean and var, dx, dscale and
    dbias equal the composed chain's bit for bit (C = 64 takes the kernels'
    16-byte vectors, C = 12 bf16 one channel a thread), on windows with
    tied positive maxima and windows whose elements are all <= 0."""
    from seld_tpu_torch.ops.batch_norm import batch_norm_pool_applicable
    fused, composed = _fused_and_composed(c, dtype, window)
    names = ("pooled", "mean", "var", "dx", "dscale", "dbias")
    for name, got, want in zip(names, fused, composed):
        assert got.dtype == want.dtype, name
        assert torch.equal(got, want), name
    x, scale, bias, _ = _pool_inputs(c, dtype, window)
    from seld_tpu_torch.models.layers import BatchNorm
    bn = BatchNorm(c).train()
    with torch.no_grad():
        y = torch.func.functional_call(bn, {"scale": scale, "bias": bias},
                                       (x,))
    from seld_tpu_torch.ops.pooling import _windows
    r = _windows(torch.relu(y), window)
    top = r.amax(dim=(2, 4), keepdim=True)
    ties = ((r == top) & (top > 0)).sum(dim=(2, 4)) > 1
    assert ties.any() and (top == 0).any()
    assert batch_norm_pool_applicable(x.shape, dtype, window) == (
        c % (16 // x.element_size()) == 0)


def test_fused_pool_saves_one_full_size_tensor():
    """Autograd keeps x and the pooled tensors of the Function: one tensor
    of x's size (x), where the composed chain keeps the ReLU output too."""
    from seld_tpu_torch.ops.batch_norm import (batch_norm_relu_pool_train,
                                               batch_norm_train)
    from seld_tpu_torch.ops.pooling import max_pool
    x, scale, bias, _ = _pool_inputs(64, torch.bfloat16, (5, 4))
    x.requires_grad_(True)

    def full_size(fn):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel()) or t, lambda t: t):
            fn()
        return sum(n == x.numel() for n in saved)
    assert full_size(lambda: batch_norm_relu_pool_train(
        x, scale, bias, EPS, (5, 4))) == 1
    assert full_size(lambda: max_pool(torch.relu(batch_norm_train(
        x, scale, bias, EPS)[0]), (5, 4), strides=(5, 4))) > 1


def test_pool_applicability():
    from seld_tpu_torch.ops.batch_norm import batch_norm_pool_applicable
    f32, bf16 = torch.float32, torch.bfloat16
    assert batch_norm_pool_applicable((256, 300, 64, 64), bf16, (5, 4))
    assert batch_norm_pool_applicable((2, 10, 8, 12), f32, (5, 4))
    assert not batch_norm_pool_applicable((2, 10, 8, 12), bf16, (5, 4))
    assert not batch_norm_pool_applicable((2, 12, 8, 64), bf16, (5, 4))
    assert not batch_norm_pool_applicable((2, 10, 6, 64), bf16, (5, 4))
    assert not batch_norm_pool_applicable((2, 16, 16, 64), bf16, (16, 16))
    assert batch_norm_pool_applicable((2, 15, 17, 64), bf16, (15, 17))
    assert not batch_norm_pool_applicable((2, 10, 64), bf16, (5, 4))
    assert not batch_norm_pool_applicable((2, 10, 8, 64), torch.float16,
                                          (5, 4))
    assert not batch_norm_pool_applicable((2 ** 20, 64, 32, 8), f32, (1, 1))


def _counting(monkeypatch, module, name):
    """Count the calls of `module.name`, which still runs."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("block", ["simple_conv_block", "cond_conv_block"])
def test_conv_blocks_take_the_fused_pool_in_training(block, monkeypatch):
    """SELDnet's and CondSELDnet's conv stacks: one fused Function a layer
    in training; eval mode composes; so does a layer whose pool does not
    divide its T (T = 12 under [5, 4]: the first layer; the two after it
    take the Function)."""
    import seld_tpu_torch.models.layers as layers
    from seld_tpu_torch.config.registry import get_block
    calls = _counting(monkeypatch, layers, "batch_norm_relu_pool_train")
    args = {"filters": [8, 8, 8], "pool_size": [[5, 4], [1, 4], [1, 2]],
            "num_experts": 2}
    x = torch.from_numpy(np.random.RandomState(3).randn(
        2, 10, 32, 3).astype(np.float32))
    net = get_block(block)(args)((10, 32, 3))
    net.train()(x)
    assert len(calls) == 3
    with torch.no_grad():
        net.eval()(x)
    assert len(calls) == 3
    odd = get_block(block)(args)((12, 32, 3))
    odd.train()(torch.zeros(2, 12, 32, 3))
    assert len(calls) == 5


def test_stem_keeps_the_fused_stem(monkeypatch):
    """SS5's stem (a Conv2DBN with a pool) stays conv_bn_relu_pool, with
    stem_dy's backward on the card, and takes no pooled BatchNorm."""
    import seld_tpu_torch.models.layers as layers
    pooled = _counting(monkeypatch, layers, "batch_norm_relu_pool_train")
    stem = _counting(monkeypatch, layers, "conv_bn_relu_pool")
    conv = layers.Conv2DBN((20, 8, 3), 16, 3, pool=(5, 2)).train()
    conv(torch.randn(2, 20, 8, 3))
    assert len(stem) == 1 and not pooled


def test_pool_plan_mirrors_the_kernel_source():
    """Passes 3' and 4' run pass 3 and 4's plan (`plan(rows, C, N)`, 3'
    checked against the blocks the twins' `_plan` gives), so the twins'
    `_ordered_sum` is their order too; the count's byte and the divisors'
    range are the wrapper's rules."""
    import re

    from seld_tpu_torch.ops import batch_norm as bn
    from seld_tpu_torch.ops import kernels
    with open(os.path.join(kernels.CSRC_DIR, "batch_norm.cu")) as f:
        src = f.read()
    for fn in ("pool_grad_sums", "pool_grad_apply"):
        body = re.search(r"cudaError_t %s\(.*?\n}\n" % fn, src, re.S)
        assert body and "const Plan pl = plan(rows, C, N);" in body.group(0)
        assert f"batch_norm_{fn}_kernel<T, TY, N><<<pl.grid, kThreads" in \
            body.group(0)
    assert "if (static_cast<int>(pl.grid.x) != blocks) return" in re.search(
        r"cudaError_t pool_grad_sums\(.*?\n}\n", src, re.S).group(0)
    assert "wt * wf > 255" in src and "rows >= (1ll << 31)" in src
    for name in ("apply", "share", "grad_sums", "grad_apply"):
        assert f"batch_norm_pool_{name}_kernel" in src
    for name in ("apply", "grad_sums", "grad_apply"):
        assert f"int seld_batch_norm_pool_{name}(" in src
    assert kernels.KERNELS["batch_norm_pool"] == "batch_norm.cu"
    # SELDnet's three blocks at B=256, 8 bf16 channels a thread
    assert bn._plan(256 * 300 * 64, 64, 8) == (32, 4096)
    assert bn._plan(256 * 60 * 16, 64, 8) == (32, 1920)
    assert bn._plan(256 * 60 * 4, 64, 8) == (32, 480)


def test_passes_refuse_other_devices():
    from seld_tpu_torch.ops.batch_norm import batch_norm_stats
    with pytest.raises(ValueError, match="cpu or cuda"):
        batch_norm_stats(torch.zeros(4, 3, device="meta"))


def test_stem_statistics_keep_their_formula():
    """The fused stem's batch mean and var, now from pass 1's sums, against
    the formula it had: f32 means of y and y^2 over the conv output."""
    import torch.nn.functional as F

    from seld_tpu_torch.ops.stem import _pad_same, conv_bn_relu_pool
    rng = np.random.RandomState(5)
    x, kernel, bias = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(4, 20, 8, 3) + 0.5, 0.3 * rng.randn(3, 3, 3, 16),
        0.1 * rng.randn(16)))
    gamma, beta = torch.ones(16), torch.zeros(16)
    _, mean, var = conv_bn_relu_pool(x, kernel, bias, gamma, beta, (5, 2),
                                     EPS)
    x_pad, _ = _pad_same(x.movedim(-1, 1), (3, 3))
    y = F.conv2d(x_pad, kernel.permute(3, 2, 0, 1)) + bias[:, None, None]
    yf = y.float()
    want_mean = yf.mean(dim=(0, 2, 3))
    want_var = yf.square().mean(dim=(0, 2, 3)) - want_mean.square()
    torch.testing.assert_close(mean, want_mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(var, want_var, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- two ranks

DP_C, DP_B = 32, 8


def _dp_inputs():
    """A batch of DP_B whose halves differ in offset and scale, so each
    half's statistics differ from the whole's."""
    x, scale, bias, cot = _inputs(DP_C, torch.float32, seed=6,
                                  shape=(DP_B, 6, 5))
    half = DP_B // 2
    x[half:] = x[half:] * 3 + 2
    return x, scale, bias, cot


DP_POOL = (3, 5)       # the fused pooled BatchNorm's window over [6, 5]


def dp_step(mesh, rank=0, world=1, other_thread=False, pool=None):
    """BatchNorm in training mode over this rank's rows (all with no mesh)
    inside the step's data-parallel span, then ReLU and the max pool
    `pool` as one fused Function where given: (y or the pooled output, dx,
    dscale, dbias, running mean, running var), the backward on another
    thread when `other_thread`."""
    from seld_tpu_torch.models.layers import BatchNorm
    from seld_tpu_torch.parallel import collectives
    x, scale, bias, cot = _dp_inputs()
    if pool is not None:
        cot = cot[:, ::pool[0], ::pool[1]]
    rows = DP_B // world
    x, cot = (t[rank * rows:(rank + 1) * rows] for t in (x, cot))
    bn = BatchNorm(DP_C).train()
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
    x.requires_grad_(True)
    with collectives.data_parallel(mesh):
        y = bn(x) if pool is None else bn(x, relu_pool=pool)
        loss = (y * cot).sum()
    out = {}

    def backward():
        out["g"] = torch.autograd.grad(loss, (x, bn.scale, bn.bias))
    if other_thread:
        thread = threading.Thread(target=backward)
        thread.start()
        thread.join()
    else:
        backward()
    return (y.detach(), *out["g"], bn.mean.clone(), bn.var.clone())


def _worker(rank, world, port, out):
    import torch.distributed as dist

    from seld_tpu_torch.parallel.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    mesh = make_mesh("data:-1", "cpu")
    torch.save([dp_step(mesh, rank, world, other_thread=True, pool=pool)
                for pool in (None, DP_POOL)],
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_rank_step_equals_one_process_over_the_batch(tmp_path):
    """Two gloo ranks, half the batch each, the backward on another thread
    than the forward: each rank's output and input gradient are its rows
    of one process's over the whole batch; its running statistics are the
    whole batch's; its dscale and dbias are its rows' share, which sum
    over the ranks to the whole batch's. Both for the BatchNorm alone and
    for the fused BatchNorm -> ReLU -> max pool."""
    from seld_tpu_torch.ops.batch_norm import batch_norm_pool_applicable
    assert batch_norm_pool_applicable((DP_B // 2, 6, 5, DP_C), torch.float32,
                                      DP_POOL)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for p in procs:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log
    saved = [torch.load(os.path.join(tmp_path, f"rank{r}.pt"))
             for r in range(2)]
    for case, pool in enumerate((None, DP_POOL)):
        ranks = [s[case] for s in saved]
        y, dx, dscale, dbias, mean, var = dp_step(None, pool=pool)
        local = dp_step(None, 0, 2, pool=pool)
        tol = dict(rtol=0, atol=1e-5)
        torch.testing.assert_close(torch.cat([r[0] for r in ranks]), y,
                                   **tol)
        torch.testing.assert_close(torch.cat([r[1] for r in ranks]), dx,
                                   rtol=0, atol=1e-5 * dx.abs().max().item())
        torch.testing.assert_close(ranks[0][2] + ranks[1][2], dscale, **tol)
        torch.testing.assert_close(ranks[0][3] + ranks[1][3], dbias, **tol)
        for r in ranks:
            torch.testing.assert_close(r[4], mean, **tol)
            torch.testing.assert_close(r[5], var, **tol)
        # the halves' own statistics are not the whole batch's
        assert (local[4] - mean).abs().max() > 1e-3


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4])
