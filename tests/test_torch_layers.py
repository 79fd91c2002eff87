"""The port's primitive layers (seld_tpu_torch/models/layers.py, ops/) against
seld_tpu's flax layers on the same numpy inputs and bridged weights.

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
from seld_tpu_torch.ops.pooling import max_pool

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


def test_max_pool_refuses_overlap():
    with pytest.raises(NotImplementedError):
        max_pool(torch.zeros(1, 4, 4, 1), (2, 2), strides=(1, 1))


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
