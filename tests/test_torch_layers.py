"""The port's primitive layers (seld_tpu_torch/models/layers.py, ops/) against
seld_tpu's flax layers on the same numpy inputs and bridged weights; the
pools against `seld_tpu.ops.pooling.max_pool` and flax's avg_pool, forward
and backward, on data with ties.

Tolerance: 1e-5 abs in f32 — same formulas, different summation order.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.models import layers as jl
from seld_tpu.ops.pooling import max_pool as jax_max_pool
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.models import layers as tl
from seld_tpu_torch.ops.dropout import dropout
from seld_tpu_torch.ops.pooling import avg_pool, max_pool

torch.set_num_threads(1)
ATOL = 1e-5


def _init(module, *args, **kw):
    v = module.init({"params": jax.random.PRNGKey(0)}, *args, **kw)
    return jax.tree_util.tree_map(np.asarray, v)


def _random_stats(v, seed=1):
    """Randomise BatchNorm running stats so eval BN is not the identity."""
    rng = np.random.RandomState(seed)

    def f(path, a):
        if path[-1].key == "mean":
            return (0.5 * rng.randn(*a.shape)).astype(np.float32)
        return (0.5 + rng.rand(*a.shape)).astype(np.float32)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            f, v["batch_stats"])
    return v


def _load(module, v):
    module.load_state_dict(from_flax(v, module))
    return module.eval()


def _run(module, *xs):
    with torch.inference_mode():
        return module(*map(torch.from_numpy, xs)).numpy()


@pytest.mark.parametrize("size,k,s,pads", [
    (32, 3, 3, (0, 1)),     # mother-stage conv: F=32, stride 3
    (32, 1, 3, (0, 0)),     # 1x1 stride-3 skip conv
    (60, 24, 1, (11, 12)),  # BLOCK2 depthwise k=24
    (60, 8, 1, (3, 4)),     # SED depthwise k=8
    (64, 7, 1, (3, 3)),     # stem
])
def test_same_padding_is_xla_asymmetric(size, k, s, pads):
    assert tl.same_padding(size, k, s) == pads


@pytest.mark.parametrize("ksize,strides,cin", [
    ((3, 3), (1, 3), 16), ((1, 1), (1, 3), 16), ((7, 7), (1, 1), 7),
    ((2, 4), (2, 2), 5)])
def test_conv2d_strided_same(ksize, strides, cin):
    x = np.random.RandomState(0).randn(4, 12, 32, cin).astype(np.float32)
    jm = jl.Conv(24, ksize, strides=strides)
    v = _init(jm, jnp.asarray(x))
    v["params"]["bias"] = np.linspace(-1, 1, 24).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = _load(tl.Conv(cin, 24, ksize, strides=strides), v)
    assert tm.out_shape_of(x.shape[1:]) == want.shape[1:]
    np.testing.assert_allclose(_run(tm, x), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("k", [24, 8, 3])
def test_depthwise_conv1d_even_kernel(k):
    x = np.random.RandomState(1).randn(4, 60, 16).astype(np.float32)
    jm = jl.Conv(16, (k,), padding="SAME", feature_group_count=16)
    v = _init(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = _load(tl.Conv(16, 16, (k,), feature_group_count=16), v)
    np.testing.assert_allclose(_run(tm, x), want, rtol=0, atol=ATOL)


def test_conv_valid_padding():
    x = np.random.RandomState(2).randn(2, 9, 11, 3).astype(np.float32)
    jm = jl.Conv(5, (3, 2), strides=(2, 1), padding="VALID")
    v = _init(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = _load(tl.Conv(3, 5, (3, 2), strides=(2, 1), padding="VALID"), v)
    assert tm.out_shape_of(x.shape[1:]) == want.shape[1:]
    np.testing.assert_allclose(_run(tm, x), want, rtol=0, atol=ATOL)


def test_batchnorm_eval_uses_running_stats_eps_1e3():
    x = np.random.RandomState(3).randn(4, 6, 5, 8).astype(np.float32)
    jm = jl.BatchNorm()
    v = _random_stats(_init(jm, jnp.asarray(x)))
    v["params"]["scale"] = np.linspace(0.5, 2, 8).astype(np.float32)
    v["params"]["bias"] = np.linspace(-1, 1, 8).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = _load(tl.BatchNorm(8), v)
    np.testing.assert_allclose(_run(tm, x), want, rtol=0, atol=ATOL)
    # bf16 input, f32 params: the result is promoted to f32, as in flax
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.inference_mode():
        assert tm(xb).dtype == torch.float32


def test_batchnorm_train_mode_batch_stats_and_running_update():
    x = np.random.RandomState(4).randn(4, 6, 8).astype(np.float32)
    jm = jl.BatchNorm()
    v = _random_stats(_init(jm, jnp.asarray(x)))
    want, upd = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tm = tl.BatchNorm(8)
    tm.load_state_dict(from_flax(v, tm))
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(tm, key).numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=0, atol=1e-6)


def test_layernorm_and_dense():
    x = np.random.RandomState(5).randn(4, 7, 12).astype(np.float32) * 3 + 1
    jln = fnn.LayerNorm(epsilon=1e-3)
    v = _init(jln, jnp.asarray(x))
    v["params"]["scale"] = np.linspace(0.5, 2, 12).astype(np.float32)
    want = np.asarray(jln.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(_run(_load(tl.LayerNorm(12, 1e-3), v), x),
                               want, rtol=0, atol=ATOL)

    jd = fnn.Dense(9, kernel_init=fnn.initializers.glorot_uniform())
    v = _init(jd, jnp.asarray(x))
    v["params"]["bias"] = np.linspace(-1, 1, 9).astype(np.float32)
    want = np.asarray(jd.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(_run(_load(tl.Dense(12, 9), v), x), want,
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("use_bias", [True, False])
def test_multi_head_attention(use_bias):
    rng = np.random.RandomState(6)
    x = rng.randn(4, 10, 16).astype(np.float32)
    jm = jl.MultiHeadAttention(4, 6, use_bias=use_bias)
    v = _init(jm, *(jnp.asarray(x),) * 3)
    v = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32), v)
    want = np.asarray(jm.apply(v, *(jnp.asarray(x),) * 3))
    tm = _load(tl.MultiHeadAttention(16, 16, 16, 4, 6, use_bias=use_bias), v)
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        got = tm(xt, xt, xt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_conv2dbn_with_pool_eval():
    x = np.random.RandomState(7).randn(4, 30, 16, 7).astype(np.float32)
    jm = jl.Conv2DBN(8, 7, padding="SAME", activation="relu", pool=(5, 2))
    v = _random_stats(_init(jm, jnp.asarray(x), train=False))
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm = _load(tl.Conv2DBN((30, 16, 7), 8, 7, pool=(5, 2)), v)
    assert tm.out_shape == want.shape[1:] == (6, 8, 8)
    np.testing.assert_allclose(_run(tm, x), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,window", [
    ((2, 300, 64, 3), (5, 2)), ((2, 13, 9, 4), (5, 2)), ((1, 7, 7, 2), (1, 3))])
def test_max_pool_valid(shape, window):
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    want = np.asarray(jax_max_pool(jnp.asarray(x), window, strides=window))
    got = max_pool(torch.from_numpy(x), window, strides=window).numpy()
    np.testing.assert_array_equal(got, want)


def _tied(shape, seed):
    """Values on a coarse grid: windows hold exact ties."""
    rng = np.random.RandomState(seed)
    return (rng.randint(-3, 4, shape) / 2.0).astype(np.float32)


def _vjp_jax(fn, x, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def _vjp_torch(fn, x, g):
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(xt)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("shape,window,strides,padding", [
    ((1, 4, 4, 1), (2, 2), (1, 1), "VALID"),   # once refused: overlapping
    ((2, 5, 6, 3), (2, 2), (1, 1), "SAME"),
    ((2, 6, 32, 5), (1, 3), (1, 2), "SAME"),   # XceptionBody, even F
    ((2, 6, 31, 5), (1, 3), (1, 2), "SAME"),   # odd F
    ((2, 6, 7, 4), (1, 3), (1, 2), "SAME"),
    ((2, 7, 9, 2), (3, 3), (2, 2), "VALID"),
], ids=["overlap-valid", "overlap-same", "xception-f32", "xception-f31",
        "xception-f7", "strided-valid"])
def test_max_pool_overlapping_matches_jax(shape, window, strides, padding):
    """Forward equal, and the backward equal on data with ties: F.max_pool2d
    and XLA's select-and-scatter both route a window's cotangent to its
    first maximum (the SAME pad cell, -inf, never wins)."""
    x = _tied(shape, 13)
    want_y, vjp = jax.vjp(lambda a: jax_max_pool(a, window, strides,
                                                  padding), jnp.asarray(x))
    g = np.random.RandomState(14).randn(*want_y.shape).astype(np.float32)
    want_dx = np.asarray(vjp(jnp.asarray(g))[0])
    got_y, got_dx = _vjp_torch(lambda a: max_pool(a, window, strides,
                                                   padding), x, g)
    np.testing.assert_array_equal(got_y, np.asarray(want_y))
    np.testing.assert_allclose(got_dx, want_dx, rtol=0, atol=1e-6)


def test_max_pool_valid_ties_route_the_same_total():
    """The non-overlapping VALID pool (amax) splits a window's cotangent
    evenly over tied maxima, where XLA's select-and-scatter gives it all to
    one: the forward is equal and each window routes the same total."""
    x = _tied((2, 10, 8, 3), 15)
    g = np.random.RandomState(16).randn(2, 2, 4, 3).astype(np.float32)
    want_y, want_dx = _vjp_jax(lambda a: jax_max_pool(a, (5, 2), (5, 2)),
                               x, g)
    got_y, got_dx = _vjp_torch(lambda a: max_pool(a, (5, 2), (5, 2)), x, g)
    np.testing.assert_array_equal(got_y, want_y)

    def per_window(d):
        return d.reshape(2, 2, 5, 4, 2, 3).sum(axis=(2, 4))
    np.testing.assert_allclose(per_window(got_dx), per_window(want_dx),
                               rtol=0, atol=1e-6)
    assert not np.array_equal(got_dx, want_dx)    # ties split


@pytest.mark.parametrize("shape,window", [
    ((2, 6, 8, 5), (1, 2)), ((2, 6, 7, 5), (1, 2)), ((2, 10, 9, 3), (5, 2))],
    ids=["even-f", "odd-f", "5x2-odd"])
def test_avg_pool_matches_flax(shape, window):
    """flax.linen.avg_pool, VALID (DenseNetStage's transition): forward and
    backward, a trailing remainder dropped."""
    x = np.random.RandomState(17).randn(*shape).astype(np.float32)
    out = (shape[0], shape[1] // window[0], shape[2] // window[1], shape[3])
    g = np.random.RandomState(18).randn(*out).astype(np.float32)
    want_y, want_dx = _vjp_jax(lambda a: fnn.avg_pool(a, window,
                                                      strides=window), x, g)
    got_y, got_dx = _vjp_torch(lambda a: avg_pool(a, window), x, g)
    np.testing.assert_allclose(got_y, want_y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_dx, want_dx, rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", ["relu", "sigmoid", "tanh", "swish", "silu",
                                  "gelu", "elu", "softmax", "linear"])
def test_get_activation(name):
    x = np.linspace(-4, 4, 24).astype(np.float32).reshape(2, 12)
    ja, ta = jl.get_activation(name), tl.get_activation(name)
    if ja is None:
        assert ta is None
        return
    np.testing.assert_allclose(ta(torch.from_numpy(x)).numpy(),
                               np.asarray(ja(jnp.asarray(x))), rtol=0,
                               atol=1e-6)


def test_get_activation_unknown():
    with pytest.raises(ValueError, match="unknown activation"):
        tl.get_activation("nope")


@pytest.mark.parametrize("mode", ["mul", "concat", "ave", "avg", "sum"])
def test_merge_bidirectional(mode):
    rng = np.random.RandomState(9)
    a, b = rng.randn(2, 3, 4).astype(np.float32), rng.randn(2, 3, 4).astype(
        np.float32)
    want = np.asarray(jl.merge_bidirectional(jnp.asarray(a), jnp.asarray(b),
                                             mode))
    got = tl.merge_bidirectional(torch.from_numpy(a), torch.from_numpy(b),
                                 mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_force_1d_and_pos_encoding():
    x = np.random.RandomState(10).randn(2, 5, 3, 4).astype(np.float32)
    np.testing.assert_array_equal(tl.force_1d(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.force_1d(jnp.asarray(x))))
    assert tl.force_1d_shape((5, 3, 4)) == (5, 12)
    np.testing.assert_allclose(tl.basic_pos_encoding(10, 8).numpy(),
                               np.asarray(jl.basic_pos_encoding(10, 8)),
                               rtol=0, atol=1e-6)


def test_dropout_identity_in_eval_inverted_in_train():
    x = torch.ones(200, 200)
    assert dropout(x, 0.3, training=False) is x
    assert dropout(x, 0.0, training=True) is x
    y = dropout(x, 0.25, training=True)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.02


def test_keras_style_init_statistics():
    g = torch.Generator().manual_seed(0)
    w = tl.glorot_uniform((3, 3, 32, 96), g)
    limit = np.sqrt(6.0 / (9 * 32 + 9 * 96))
    assert w.abs().max().item() <= limit
    assert w.abs().max().item() > 0.9 * limit
    q = tl.orthogonal((2, 16, 48), g).reshape(32, 48)
    np.testing.assert_allclose((q @ q.T).numpy(), np.eye(32), atol=1e-5)
    gru = tl.GRU(8, 16, bidirectional=True, generator=g)
    assert gru.bias.abs().sum() == 0
    # same seed, same weights
    a = tl.Conv(4, 8, (3,), generator=torch.Generator().manual_seed(1))
    b = tl.Conv(4, 8, (3,), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.kernel, b.kernel)
