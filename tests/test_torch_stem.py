"""The port's fused stem (seld_tpu_torch/ops/stem.py, ops/stem_bwd.py)
against the JAX package: `conv_bn_relu_pool` forward and backward (whose
dy pass runs the Pallas `stem_dy` in interpret mode on the CPU), the plain
`stem_dy_ref` against `_dy_xla` and the Pallas `stem_dy` on data with pool
ties, and the train-mode `Conv2DBN` against the JAX `Conv2DBN` on its fused
path (SELD_FUSED_STEM=always, set per test).

Tolerances: 1e-5 for f32 forwards (the conv's sums run in another order);
2e-4 for gradients, which pass through the conv's reductions over
B*T*F terms (as tests/test_stem.py); dy from the same y, dpooled and
params6 is the same f32 formula on both sides, to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.models.layers import Conv2DBN as JaxConv2DBN
from seld_tpu.ops import stem as jax_stem
from seld_tpu.ops.pallas import stem_bwd as jax_stem_bwd
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.models.layers import Conv2DBN
from seld_tpu_torch.ops import kernels, stem, stem_bwd

torch.set_num_threads(1)
FWD_TOL, GRAD_TOL, DY_TOL = 1e-5, 2e-4, 1e-6
POOL = (5, 2)


def _data(b=3, t=20, f=8, ci=7, co=16, seed=0):
    """Distinct inputs, so no pool window holds a tie and autodiff's
    first-match routing and the count-normalised routing agree."""
    rng = np.random.RandomState(seed)
    x = rng.permutation(np.arange(b * t * f * ci, dtype=np.float32))
    x = (x.reshape(b, t, f, ci) / x.size - 0.5) * 4
    kernel = rng.randn(7, 7, ci, co).astype(np.float32) * 0.2
    bias = rng.randn(co).astype(np.float32) * 0.1
    gamma = rng.rand(co).astype(np.float32) * 0.8 + 0.6
    beta = rng.randn(co).astype(np.float32) * 0.2
    return x, kernel, bias, gamma, beta


def _tied_dy_inputs(dtype, seed=1, b=2, t=20, f=8, c=16):
    """y on a coarse grid with many negatives: windows hold exact ties of
    their positive maximum and ReLU zeros."""
    rng = np.random.RandomState(seed)
    y = (rng.randint(-6, 5, (b, t, f, c)) / 4.0).astype(np.float32)
    dp = rng.randn(b, t // POOL[0], f // POOL[1], c).astype(np.float32)
    p6 = np.stack([0.1 * rng.randn(c), 1 + 0.1 * rng.rand(c),
                   1 + 0.2 * rng.rand(c), 0.1 * rng.randn(c),
                   1e-3 * rng.randn(c), 1e-3 * rng.randn(c)]
                  ).astype(np.float32)
    yt = torch.from_numpy(y).to(dtype)
    return yt, torch.from_numpy(dp), torch.from_numpy(p6)


def test_fused_forward_and_grads_match_jax():
    x, kernel, bias, gamma, beta = _data()
    w = np.random.RandomState(2).randn(3, 4, 4, 16).astype(np.float32)

    def jax_loss(*args):
        pooled, _, _ = jax_stem.conv_bn_relu_pool(*args, POOL, 1e-3)
        return jnp.sum(jnp.sin(pooled) ** 2 * w)

    jargs = [jnp.asarray(a) for a in (x, kernel, bias, gamma, beta)]
    want_fwd = jax_stem.conv_bn_relu_pool(*jargs, POOL, 1e-3)
    want_grads = jax.grad(jax_loss, argnums=range(5))(*jargs)

    targs = [torch.from_numpy(a).requires_grad_()
             for a in (x, kernel, bias, gamma, beta)]
    before = kernels.launch_counts["stem_dy"]
    got_fwd = stem.conv_bn_relu_pool(*targs, POOL, 1e-3)
    (torch.sin(got_fwd[0]) ** 2 * torch.from_numpy(w)).sum().backward()
    assert kernels.launch_counts["stem_dy"] == before
    for g, want in zip(got_fwd, want_fwd):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    names = ("dx", "dkernel", "dbias", "dgamma", "dbeta")
    for name, a, want in zip(names, targs, want_grads):
        assert a.grad.dtype == a.dtype
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_dy_ref_matches_jax_on_ties(dtype):
    y, dp, p6 = _tied_dy_inputs(getattr(torch, dtype))
    got_dy, got_db = stem_bwd.stem_dy_ref(y, dp, p6, POOL)
    yj = jnp.asarray(y.float().numpy()).astype(getattr(jnp, dtype))
    dpj, p6j = jnp.asarray(dp.numpy()), jnp.asarray(p6.numpy())
    want_xla = jax_stem._dy_xla(yj, dpj, p6j, POOL)
    want_pallas = jax_stem_bwd.stem_dy(yj, dpj, p6j, POOL, interpret=True)
    assert got_dy.dtype == y.dtype and got_db.dtype == torch.float32
    # exactly one bf16 rounding of the same f32 value on both sides
    dy_tol = DY_TOL if dtype == "float32" else 2.0 ** -8
    for want_dy, want_db in (want_xla, want_pallas):
        np.testing.assert_allclose(got_dy.float().numpy(),
                                   np.asarray(want_dy, np.float32),
                                   rtol=dy_tol, atol=DY_TOL)
        np.testing.assert_allclose(got_db.numpy(), np.asarray(want_db),
                                   rtol=1e-5, atol=1e-5)


def test_stem_dy_on_cpu_writes_out_and_routes_ties_by_count():
    y, dp, p6 = _tied_dy_inputs(torch.float32, seed=3)
    want_dy, want_db = stem_bwd.stem_dy_ref(y, dp, p6, POOL)
    out = torch.empty_like(y)
    dy, db = stem_bwd.stem_dy(y, dp, p6, POOL, out=out)
    assert dy is out and torch.equal(dy, want_dy) and torch.equal(db,
                                                                  want_db)
    # with the BN terms zeroed, a window's routed mass is dpooled where its
    # maximum is positive, split over its ties
    p6[4:] = 0
    dy, _ = stem_bwd.stem_dy_ref(y, dp, p6, POOL)
    scale = (p6[1] * p6[2])
    routed = (dy / scale).reshape(2, 4, 5, 4, 2, 16).sum(dim=(2, 4))
    bno = y * (p6[1] * p6[2]) + (p6[3] - p6[2] * p6[0] * p6[1])
    m = bno.reshape(2, 4, 5, 4, 2, 16).amax(dim=(2, 4))
    torch.testing.assert_close(routed, dp * (m > 0), rtol=1e-5, atol=1e-6)


def test_routing_sees_the_forwards_exact_bf16_values():
    """The backward routes a window's gradient to the elements equal to the
    forward's saved maximum. In bf16 that holds only if bno is recomputed
    exactly as the forward computed it (`bn_affine`, then y*scale + shift
    in bf16). This data is chosen so that the textbook formula
    (y - mean) * inv * gamma + beta misses the maximum in some windows:
    with it, their gradient would silently vanish."""
    rng = np.random.RandomState(4)
    b, t, f, c = 2, 20, 8, 16
    x = torch.from_numpy(rng.randn(b, t, f, 3).astype(np.float32)
                         ).to(torch.bfloat16)
    kernel = torch.from_numpy(0.3 * rng.randn(3, 3, 3, c).astype(
        np.float32)).to(torch.bfloat16).requires_grad_()
    bias = torch.zeros(c, dtype=torch.bfloat16, requires_grad=True)
    gamma = torch.from_numpy((0.7 + rng.rand(c)).astype(np.float32))
    beta = torch.from_numpy((0.3 * rng.randn(c)).astype(np.float32))
    pooled, mean, var = stem.conv_bn_relu_pool(x, kernel, bias, gamma, beta,
                                               POOL, 1e-3)
    dp = torch.ones_like(pooled, dtype=torch.float32)
    y = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.movedim(-1, 1), (1, 1, 1, 1)),
        kernel.detach().permute(3, 2, 0, 1)).movedim(1, -1)
    inv = torch.rsqrt(var + 1e-3)
    zeros = torch.zeros(c)
    p6 = torch.stack([mean, inv, gamma, beta, zeros, zeros])
    dy, _ = stem_bwd.stem_dy_ref(y, dp, p6, POOL)
    routed = (dy.float() / (inv * gamma)).reshape(
        b, t // 5, 5, f // 2, 2, c).sum(dim=(2, 4))
    torch.testing.assert_close(routed, (pooled > 0).float(), rtol=2e-2,
                               atol=0)

    other = ((y.float() - mean) * inv * gamma + beta).to(torch.bfloat16)
    m_other = other.float().reshape(b, t // 5, 5, f // 2, 2, c).amax(
        dim=(2, 4))
    assert (m_other != pooled.float()).logical_and(pooled > 0).any(), \
        "the data must separate the two formulas"


def test_second_backward_through_the_stem_raises():
    """dy is written over y (y is dead after the pass): the graph's saved y
    is spent, and a second backward says so instead of reading dy."""
    targs = [torch.from_numpy(a).requires_grad_() for a in _data(seed=5)]
    pooled, _, _ = stem.conv_bn_relu_pool(*targs, POOL, 1e-3)
    pooled.sum().backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        pooled.sum().backward()


@pytest.mark.parametrize("case,exc,match", [
    ("rank", ValueError, r"\[B, T, F, C\]"),
    ("pool", ValueError, "must divide"),
    ("window", ValueError, "more than 16"),
    ("dpooled", ValueError, "dpooled .* does not match"),
    ("params6", ValueError, "params6 must be"),
    ("ydtype", TypeError, "y dtype"),
    ("out", ValueError, "out must have"),
])
def test_stem_dy_cuda_wrapper_checks_raise(case, exc, match):
    y, dp, p6 = _tied_dy_inputs(torch.float32)
    pool, out = POOL, torch.empty_like(y)
    if case == "rank":
        y = y[0]
    elif case == "pool":
        pool = (3, 2)
    elif case == "window":
        pool = (10, 2)
    elif case == "dpooled":
        dp = dp[:, :2]
    elif case == "params6":
        p6 = p6.double()
    elif case == "ydtype":
        y, out = y.half(), out.half()
    elif case == "out":
        out = torch.empty(2, 8, 20, 16).transpose(1, 2)
    with pytest.raises(exc, match=match):
        stem_bwd._check_cuda_args(y, dp, p6, pool, out)


def test_fused_stem_applicable_rules():
    ok = dict(x_shape=(2, 300, 64, 7), pool=(5, 2), strides=(1, 1),
              padding="SAME", groups=1, activation="relu")
    assert stem.fused_stem_applicable(**ok)
    for key, value in (("pool", None), ("activation", "swish"),
                       ("groups", 2), ("padding", "VALID"),
                       ("strides", (2, 1)), ("x_shape", (2, 301, 64, 7))):
        assert not stem.fused_stem_applicable(**{**ok, key: value}), key


def test_conv2dbn_train_matches_jax_fused(monkeypatch):
    """Train-mode Conv2DBN with a pool: output, running statistics and the
    gradients of every parameter and of the input, against the JAX layer
    on its fused path."""
    monkeypatch.setenv("SELD_FUSED_STEM", "always")
    rng = np.random.RandomState(6)
    x = (rng.permutation(np.arange(2 * 20 * 8 * 7, dtype=np.float32))
         .reshape(2, 20, 8, 7) / 1000.0)
    w = rng.randn(2, 4, 4, 12).astype(np.float32)
    jm = JaxConv2DBN(12, 5, activation="relu", pool=POOL)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(1)}, jnp.asarray(x), train=False))
    v["params"]["Conv_0"]["bias"] = (0.1 * rng.randn(12)).astype(np.float32)

    def loss(params, xx):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(jnp.tanh(out) ** 2 * w), (out, mut["batch_stats"])

    (gp, gx), (want_out, want_stats) = jax.grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    tm = Conv2DBN((20, 8, 7), 12, 5, pool=POOL)
    tm.load_state_dict(from_flax(v, tm))
    tm.train()
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    (torch.tanh(out) ** 2 * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=FWD_TOL, atol=FWD_TOL)
    stats = dict(tm.named_buffers())
    for key in ("mean", "var"):
        np.testing.assert_allclose(
            stats[f"BatchNorm_0.{key}"].numpy(),
            np.asarray(want_stats["BatchNorm_0"][key]), rtol=FWD_TOL,
            atol=1e-6, err_msg=key)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    for name, p in tm.named_parameters():
        mod, leaf = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(gp[mod][leaf]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
