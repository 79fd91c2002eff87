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
    "batch_norm_grad_apply_kernel<float, float, 1>"])
def test_trace_families_of_the_passes(kernel):
    """The port's grouping names the passes' kernels batch_norm; the
    benchmark's frozen classifier, which predates them, puts them in its
    "other" family, outside elementwise_ms.train."""
    from seld_bench.yardstick.trace import family
    from seld_tpu_torch.utils.trace_analysis import _classify
    assert _classify(kernel) == "batch_norm"
    assert family(kernel) == "other"


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


def dp_step(mesh, rank=0, world=1, other_thread=False):
    """BatchNorm in training mode over this rank's rows (all with no mesh)
    inside the step's data-parallel span: (y, dx, dscale, dbias, running
    mean, running var), the backward on another thread when
    `other_thread`."""
    from seld_tpu_torch.models.layers import BatchNorm
    from seld_tpu_torch.parallel import collectives
    x, scale, bias, cot = _dp_inputs()
    rows = DP_B // world
    x, cot = (t[rank * rows:(rank + 1) * rows] for t in (x, cot))
    bn = BatchNorm(DP_C).train()
    with torch.no_grad():
        bn.scale.copy_(scale)
        bn.bias.copy_(bias)
    x.requires_grad_(True)
    with collectives.data_parallel(mesh):
        y = bn(x)
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
    torch.save(dp_step(mesh, rank, world, other_thread=True),
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
    over the ranks to the whole batch's."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for p in procs:
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log
    ranks = [torch.load(os.path.join(tmp_path, f"rank{r}.pt"))
             for r in range(2)]
    y, dx, dscale, dbias, mean, var = dp_step(None)
    local = dp_step(None, 0, 2)
    tol = dict(rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.cat([r[0] for r in ranks]), y, **tol)
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
