"""The port's config-driven blocks (seld_tpu_torch/models/modules.py) against
seld_tpu's flax blocks, built from the same config dicts, on the same numpy
inputs with bridged weights (BatchNorm running stats randomised).

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
    cfg = dict(_MOTHER_BASE, bn_pair_batch=True)
    with pytest.raises(NotImplementedError):
        get_block("mother_stage")(cfg)((8, 12, 5))


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
    args = dict(SS5["SED_ARGS"], **kw)
    with pytest.raises(NotImplementedError):
        get_block("conformer_encoder_stage")(args)((10, 32))


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
