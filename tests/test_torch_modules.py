"""The port's config-driven blocks (seld_tpu_torch/models/modules.py) against
seld_tpu's flax blocks, built from the same config dicts, on the same numpy
inputs with bridged weights (BatchNorm running stats randomised). The
legacy conv families run in eval mode and in train mode (the outputs and
the updated running statistics).

Tolerance: 1e-5 abs in f32 — same formulas, different summation order.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import get_model_config
from seld_tpu.config.registry import get_block as jax_get_block
from seld_tpu.models import modules as jm
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.config import get_block
from seld_tpu_torch.models import modules as tm

torch.set_num_threads(1)
ATOL = 1e-5
SS5 = get_model_config("SS5", search_paths=[])


def _random_stats(v, seed=1):
    rng = np.random.RandomState(seed)

    def f(path, a):
        if path[-1].key == "mean":
            return (0.3 * rng.randn(*a.shape)).astype(np.float32)
        return (0.5 + rng.rand(*a.shape)).astype(np.float32)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            f, v["batch_stats"])
    return v


def _compare(block_name, args, x, atol=ATOL):
    """Build `block_name` from `args` on both sides, bridge the weights and
    return (port output, jax output)."""
    jblock = jax_get_block(block_name)(args)
    v = jblock.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                    train=False)
    v = _random_stats(jax.tree_util.tree_map(np.asarray, v))
    want = np.asarray(jblock.apply(v, jnp.asarray(x), train=False))
    block = get_block(block_name)(args)(x.shape[1:])
    block.load_state_dict(from_flax(v, block))
    block.eval()
    assert tuple(block.out_shape) == want.shape[1:]
    with torch.inference_mode():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    return got, want


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_mother_stage_ss5_config():
    got, _ = _compare("mother_stage", SS5["BLOCK0_ARGS"], _x(4, 12, 32, 32))
    assert got.shape == (4, 12, 11, 224)


_MOTHER_BASE = {"depth": 1, "filters0": 8, "filters1": 12, "filters2": 6,
                "kernel_size0": 3, "kernel_size1": 3, "kernel_size2": 1,
                "connect0": [1], "connect1": [1, 1], "connect2": [1, 1, 1],
                "strides": [1, 2]}


@pytest.mark.parametrize("override", [
    {},                                                     # all convs
    {"squeeze_ratio": 0.5},                                 # SE
    {"filters2": 0, "kernel_size2": 0, "connect2": [1, 1, 1]},  # concat+align
    {"filters0": 0, "kernel_size0": 0, "connect1": [1, 0],
     "connect2": [1, 0, 1], "depth": 2},                    # SS5-like
    {"filters1": 0, "kernel_size1": 0, "strides": [1, 1],
     "connect2": [1, 1, 0]},                                # concat layer 2
    {"activation": "swish", "strides": [2, 1]},
])
def test_mother_stage_wirings(override):
    args = dict(_MOTHER_BASE, **override)
    _compare("mother_stage", args, _x(2, 8, 12, 5, seed=1))


def test_mother_block_single():
    _compare("mother_block", dict(_MOTHER_BASE, squeeze_ratio=0.25),
             _x(2, 8, 12, 5, seed=2))


@pytest.mark.parametrize("override,message", [
    ({"filters0": 0}, "0) skipped layer must have 0 filters, 0 kernel size"),
    ({"filters1": 0}, "1) skipped layer must have 0 filters, 0 kernel size"),
    ({"filters2": 0}, "2) skipped layer must have 0 filters, 0 kernel size"),
    ({"filters0": 0, "kernel_size0": 0},
     "cannot link skipped layer (first layer)"),
    ({"filters1": 0, "kernel_size1": 0},
     "cannot link skipped layer (second layer)"),
    ({"filters0": 0, "kernel_size0": 0, "connect0": [0],
      "connect1": [1, 0], "connect2": [1, 0, 1]},
     "cannot pass zero inputs to the second layer"),
    ({"filters1": 0, "kernel_size1": 0, "connect1": [0, 0],
      "connect2": [1, 1, 0]},
     "cannot pass zero inputs to the third layer"),
    ({"filters2": 0, "kernel_size2": 0, "connect2": [0, 0, 0]},
     "cannot pass zero inputs to the final output"),
    ({"filters1": 0, "kernel_size1": 0, "connect2": [1, 1, 0]},
     "if strides are set, the second layer must be active"),
])
def test_validate_mother_config_messages(override, message):
    cfg = dict(_MOTHER_BASE, **override)
    with pytest.raises(ValueError) as want:
        jm._validate_mother_config(cfg)
    assert str(want.value) == message
    for factory in ("mother_stage", "mother_block"):
        with pytest.raises(ValueError) as got:
            get_block(factory)(cfg)
        assert str(got.value) == message


def test_mother_bn_pair_batch_not_ported():
    """bn_pair_batch is ported: one wide BatchNorm over the main conv and
    the projected skips, the eval forward equal to the JAX block's
    (tests/test_torch_blocks.py holds train mode and a step)."""
    cfg = dict(_MOTHER_BASE, bn_pair_batch=True)
    _compare("mother_stage", cfg, _x(2, 8, 12, 5, seed=1))
    block = get_block("mother_stage")(cfg)((8, 12, 5))
    # layer 2: its conv and two strided skip projections, one BatchNorm
    assert block.MotherBlock_0.BatchNorm_2.scale.shape == (3 * 12,)


def test_simple_dense_stage_is_linear_for_ss5():
    """SS5's BLOCK1 carries only 'dense_activation': the stage overwrites
    it with 'activation' (None), so the 192-unit stage is linear."""
    got, _ = _compare("simple_dense_stage", SS5["BLOCK1_ARGS"],
                      _x(4, 12, 11, 8))
    assert got.shape == (4, 12, 192) and (got < 0).any()


def test_simple_dense_block_keeps_dense_activation():
    got, _ = _compare("simple_dense_block",
                      {"units": [16, 8], "dense_activation": "relu"},
                      _x(4, 12, 10, seed=3))
    assert (got >= 0).all()
    _compare("simple_dense_block", {"units": [5], "kernel_size": 3},
             _x(4, 12, 10, seed=4))


def _narrow_conformer(args, **kw):
    args = dict(copy.deepcopy(args), **kw)
    return args


@pytest.mark.parametrize("args", [
    SS5["BLOCK2_ARGS"],
    SS5["SED_ARGS"],
    _narrow_conformer(SS5["SED_ARGS"], pos_encoding="basic", depth=1,
                      activation="relu", multiplier=1.5),
], ids=["block2", "sed", "basic_pos"])
def test_conformer_stage(args):
    args = _narrow_conformer(args, key_dim=8)
    got, _ = _compare("conformer_encoder_stage", args, _x(4, 30, 32, seed=5))
    assert got.shape == (4, 30, 32)


def test_conformer_block_on_2d_input():
    _compare("conformer_encoder_block",
             {"key_dim": 6, "n_head": 2, "kernel_size": 4, "multiplier": 2,
              "pos_encoding": None}, _x(2, 10, 4, 6, seed=6))


@pytest.mark.parametrize("kw", [
    {"scan_depth": True}, {"pos_encoding": "rff"},
    {"pos_encoding": "basic", "pos_mode": "relative"}])
def test_conformer_unported_options_raise(kw):
    """The three options once refused are ported: each builds and its eval
    forward equals the JAX block's."""
    args = _narrow_conformer(SS5["SED_ARGS"], key_dim=8, **kw)
    got, _ = _compare("conformer_encoder_stage", args, _x(4, 10, 32, seed=5))
    assert got.shape == (4, 10, 32)


def test_bidirectional_gru_stage():
    got, _ = _compare("bidirectional_GRU_stage", {"depth": 2, "units": 16},
                      _x(8, 12, 3, 8, seed=7))
    assert got.shape == (8, 12, 16)


def test_bidirectional_gru_block():
    _compare("bidirectional_GRU_block", {"units": [16, 8]},
             _x(8, 12, 10, seed=8))


def test_tuple2_matches_reference():
    for v in (3, 2.0, [4], (1, 3), [2, 5]):
        assert tm._tuple2(v) == jm._tuple2(v)


def test_unknown_block():
    with pytest.raises(KeyError, match="unknown block type"):
        get_block("no_such_block")


def _compare_legacy(block_name, args, x, train, atol=ATOL):
    """As `_compare`, with the JAX side jitted and the variables drawn as
    flax's init draws them (glorot-uniform kernels, zero biases, unit
    BatchNorm scales) from the tree's shapes, which compiles no init, in
    eval mode or in train mode: then the output from batch statistics and
    every updated running statistic."""
    jblock = jax_get_block(block_name)(args)
    shapes = jax.eval_shape(lambda: jblock.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *x.shape[1:])),
        train=False))
    rng = np.random.RandomState(12)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan = np.prod(a.shape[:-2]) * (a.shape[-2] + a.shape[-1])
            return rng.uniform(-1, 1, a.shape).astype(np.float32) * \
                np.float32(np.sqrt(6.0 / fan))
        return np.full(a.shape, name in ("scale", "var"), np.float32)
    v = _random_stats(jax.tree_util.tree_map_with_path(draw, shapes))
    want, updated = jax.jit(lambda v, x: jblock.apply(
        v, x, train=train, mutable=["batch_stats"]))(v, jnp.asarray(x))
    block = get_block(block_name)(args)(x.shape[1:])
    block.load_state_dict(from_flax(v, block))
    block.train(train)
    assert tuple(block.out_shape) == want.shape[1:]
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)
    stats = {k: v for k, v in block.state_dict().items()
             if k.endswith((".mean", ".var"))}
    want_stats = from_flax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, updated["batch_stats"])})
    assert set(stats) == set(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(stats[k].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=k)

# (block, args, input shape): narrowed widths; pools, strides and the
# conditional projections of the zoo's families
LEGACY_BLOCKS = {
    "simple_conv": ("simple_conv_block",
                    {"filters": [4, 6], "pool_size": [[5, 2], [1, 2]]},
                    (2, 10, 8, 3)),
    "cond_conv": ("cond_conv_block",
                  {"filters": [4, 6], "pool_size": [[5, 2], [1, 2]],
                   "num_experts": 3}, (2, 10, 8, 3)),
    "another_conv": ("another_conv_block",
                     {"filters": 6, "depth": 2, "pool_size": [1, 4]},
                     (2, 6, 9, 4)),
    "res_basic_strided": ("res_basic_stage",
                          {"filters": 6, "depth": 2, "strides": [1, 2]},
                          (2, 6, 7, 4)),
    "res_basic_identity": ("res_basic_stage",
                           {"filters": 4, "depth": 2, "strides": [1, 1]},
                           (2, 6, 8, 4)),
    "res_bottleneck_strided": ("res_bottleneck_stage",
                               {"filters": 2, "depth": 3, "strides": [1, 2]},
                               (2, 6, 8, 4)),
    "res_bottleneck_identity": ("res_bottleneck_stage",
                                {"filters": 2, "depth": 2, "strides": [1, 1],
                                 "bottleneck_ratio": 2}, (2, 6, 8, 4)),
    "dense_stage": ("dense_net_block",
                    {"growth_rate": 4, "depth": 2, "strides": [1, 2],
                     "bottleneck_ratio": 2, "reduction_ratio": 0.5},
                    (2, 6, 7, 6)),
    "dense_stage_last": ("dense_net_block",
                         {"growth_rate": 4, "depth": 2, "strides": [1, 2],
                          "reduction_ratio": None}, (2, 6, 8, 5)),
    "dense_body": ("dense_net_block", {"filters": 8, "block_num": [2, 2]},
                   (2, 10, 16, 3)),
    # two stages (the second strided): at block_num [1, 2] the ten
    # train-mode BatchNorms in series leave either f32 side up to 1.6e-5
    # from an f64 run, beyond this file's tolerance
    "resnet50": ("resnet50_block", {"filters": 2, "block_num": [1, 1]},
                 (2, 10, 16, 3)),
    "xception": ("xception_block", {"filters": 2, "block_num": 1},
                 (2, 10, 14, 3)),
}


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", sorted(LEGACY_BLOCKS))
def test_legacy_conv_block_matches_jax(case, mode):
    name, args, shape = LEGACY_BLOCKS[case]
    _compare_legacy(name, args, _x(*shape, seed=11), train=mode == "train")


def test_legacy_block_names_follow_flax_creation_order():
    """A bottleneck stage's projection exists only where shapes differ, and
    flax numbers Conv_i/BatchNorm_i in creation order: the strided first
    block takes Conv_0/Conv_1 (main, projection), the later ones Conv_2, 3."""
    block = get_block("res_bottleneck_stage")(
        {"filters": 2, "depth": 3, "strides": [1, 2]})((6, 8, 4))
    convs = sorted(k for k in block.state_dict() if k.startswith("Conv_"))
    assert convs == ["Conv_0.bias", "Conv_0.kernel", "Conv_1.bias",
                     "Conv_1.kernel", "Conv_2.bias", "Conv_2.kernel",
                     "Conv_3.bias", "Conv_3.kernel"]
    assert block.Conv_1.kernel.shape == (1, 1, 4, 8)       # the projection
    assert block.Conv_2.kernel.shape == (1, 1, 2, 8)
    assert block.out_shape == (6, 4, 8)
