"""The flax <-> port parameter bridge (seld_tpu_torch/bridge.py)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import get_model_config
from seld_tpu.models import build_model as jax_build_model
from seld_tpu_torch.bridge import from_flax, to_flax
from seld_tpu_torch.models import build_model

torch.set_num_threads(1)
SHAPE = (30, 16, 7)


def _narrow():
    cfg = copy.deepcopy(get_model_config("SS5", search_paths=[]))
    cfg["filters"] = 4
    cfg["BLOCK0_ARGS"]["filters1"] = 8
    cfg["BLOCK1_ARGS"]["units"] = 16
    cfg["BLOCK2_ARGS"].update(key_dim=4, depth=1)
    cfg["SED_ARGS"]["key_dim"] = 4
    cfg["DOA_ARGS"]["units"] = 8
    return cfg


@pytest.fixture(scope="module")
def pair():
    cfg = _narrow()
    shapes = jax.eval_shape(lambda: jax_build_model(
        "conv_temporal", SHAPE, cfg).init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *SHAPE)),
            train=False))
    rng = np.random.RandomState(0)
    v = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    return build_model("conv_temporal", SHAPE, cfg, device="cpu"), v


def _flat(tree):
    return {jax.tree_util.keystr(p): a
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_names_are_flax_paths_joined(pair):
    model, v = pair
    keys = set(model.state_dict())
    want = set()
    for col in ("params", "batch_stats"):
        for path, _ in jax.tree_util.tree_flatten_with_path(v[col])[0]:
            want.add(".".join(str(k.key) for k in path))
    assert keys == want


def test_round_trip_is_exact(pair):
    model, v = pair
    model.load_state_dict(from_flax(v, model))
    back = _flat(to_flax(model))
    orig = _flat(v)
    assert set(back) == set(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k])


def test_from_flax_without_model_is_a_plain_name_map(pair):
    _, v = pair
    sd = from_flax(v)
    np.testing.assert_array_equal(
        sd["Conv2DBN_0.BatchNorm_0.mean"].numpy(),
        v["batch_stats"]["Conv2DBN_0"]["BatchNorm_0"]["mean"])


def test_raises_on_unconsumed_leaf(pair):
    model, v = pair
    bad = copy.deepcopy(v)
    bad["params"]["Conv2DBN_0"]["Conv_0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="not consumed.*extra"):
        from_flax(bad, model)


def test_raises_on_missing_leaf(pair):
    model, v = pair
    bad = copy.deepcopy(v)
    del bad["batch_stats"]["Conv2DBN_0"]["BatchNorm_0"]["var"]
    with pytest.raises(KeyError, match="not found.*BatchNorm_0.var"):
        from_flax(bad, model)


def test_raises_on_shape_mismatch(pair):
    model, v = pair
    bad = copy.deepcopy(v)
    bad["params"]["SELDHeads_0"]["sed_out"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="sed_out.bias"):
        from_flax(bad, model)


def test_raises_on_unknown_collection(pair):
    _, v = pair
    with pytest.raises(KeyError, match="unknown flax collections"):
        from_flax({**v, "intermediates": {}})


@pytest.mark.parametrize("channels", [10, 17])
def test_stem_kernel_of_mic_and_joint_inputs_crosses(channels):
    """SS5 at its published widths for the 10-channel mic and 17-channel
    joint inputs: the stem kernel [7, 7, C, 32] crosses both ways exactly,
    in the layout the conv reads (the forwards agree)."""
    shape = (30, 16, channels)
    cfg = copy.deepcopy(get_model_config("SS5", search_paths=[]))
    cfg["n_classes"] = 12
    jm = jax_build_model("conv_temporal", shape, cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape)),
        train=False))
    rng = np.random.RandomState(channels)
    v = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.1).astype(np.float32), shapes)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    stem = v["params"]["Conv2DBN_0"]["Conv_0"]["kernel"]
    assert stem.shape == (7, 7, channels, 32)
    model = build_model("conv_temporal", shape, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    back = to_flax(model)
    np.testing.assert_array_equal(
        back["params"]["Conv2DBN_0"]["Conv_0"]["kernel"], stem)
    if channels == 17:
        x = rng.randn(2, *shape).astype(np.float32)
        want = jm.apply(v, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4)


# NAS candidates as the sampler draws them (mother_stage_postprocess
# applied): connect0, connect1 and connect2 run through every pattern of the
# search space, kernel sizes 1, 3 and 5, skipped layers (0 filters) and
# strides (1, 1), (1, 2), (1, 3); heads from the 1-D space
_CONNECT1 = [[0, 0], [0, 1], [1, 0], [1, 1]]
_CONNECT2 = [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
             [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]]
_FILTERS = [(4, 6, 8), (0, 6, 8), (4, 6, 0), (4, 0, 8), (3, 4, 0),
            (0, 4, 6), (4, 6, 8), (6, 0, 4)]
_HEADS = [("bidirectional_GRU_stage", {"depth": 1, "units": 8}),
          ("simple_dense_stage", {"depth": 2, "units": 6,
                                  "dense_activation": "relu",
                                  "dropout_rate": 0.0}),
          ("bidirectional_GRU_stage", {"depth": 2, "units": 6})]


def _nas_candidate(i):
    from seld_tpu_torch.nas.sampler import mother_stage_postprocess
    f0, f1, f2 = _FILTERS[i]
    strides = [(1, 1), (1, 2), (1, 3)][i % 3] if f1 else (1, 1)
    cfg = {"n_classes": 12, "filters": 4, "first_pool_size": [5, 2],
           "BLOCK0": "mother_stage",
           "BLOCK0_ARGS": {"depth": 1 + i % 2, "filters0": f0,
                           "filters1": f1, "filters2": f2,
                           "kernel_size0": [1, 3, 5][i % 3],
                           "kernel_size1": [5, 1, 3][i % 3],
                           "kernel_size2": [3, 5, 1][i % 3],
                           "connect0": [[0], [1]][i % 2],
                           "connect1": _CONNECT1[i % 4],
                           "connect2": _CONNECT2[i], "strides": strides},
           "SED": _HEADS[i % 3][0], "SED_ARGS": _HEADS[i % 3][1],
           "DOA": _HEADS[(i + 1) % 3][0], "DOA_ARGS": _HEADS[(i + 1) % 3][1]}
    if i % 2:
        cfg["BLOCK1"] = "bidirectional_GRU_stage"
        cfg["BLOCK1_ARGS"] = {"depth": 1, "units": 4}
    return mother_stage_postprocess(cfg)


_VAD = [
    ("vad_architecture", (7, 16, 1),
     {"flatten": True, "last_unit": 7, "BLOCK0": "simple_dense_block",
      "BLOCK0_ARGS": {"units": [16, 16], "dense_activation": "relu",
                      "dropout_rate": 0.5}}),
    ("vad_architecture", (7, 16, 1),
     {"flatten": False, "last_unit": 1, "BLOCK0": "mother_stage",
      "BLOCK0_ARGS": {"depth": 1, "filters0": 4, "filters1": 8,
                      "filters2": 0, "kernel_size0": 3, "kernel_size1": 5,
                      "kernel_size2": 0, "connect0": [1],
                      "connect1": [1, 0], "connect2": [1, 0, 1],
                      "strides": [1, 2]},
      "BLOCK1": "simple_dense_block",
      "BLOCK1_ARGS": {"units": [16], "dense_activation": None}}),
    ("spectro_temporal_attention_based_VAD", (7, 16, 1),
     {"T": 2, "Nc": 4, "Np": 16, "Nt": 8, "H": 2}),
]
_CROSS = ([("conv_temporal", (50, 16, 7), _nas_candidate(i))
           for i in range(len(_CONNECT2))] + _VAD)


@pytest.mark.parametrize("name,shape,cfg", _CROSS, ids=[
    f"nas_candidate_{i}" for i in range(len(_CONNECT2))] + [
    "vad_bdnn", "vad_nas_candidate", "vad_attention"])
def test_nas_candidates_and_vad_models_cross(name, shape, cfg):
    """Every flax leaf maps onto the port's state_dict and back exactly,
    and the eval forwards agree to 1e-4 absolute (f32, sums in another
    order) on random parameters and running statistics."""
    jm = jax_build_model(name, shape, cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape)),
        train=False))
    rng = np.random.RandomState(len(str(cfg)))
    v = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * 0.3).astype(np.float32), shapes)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: np.abs(a) + 0.5, v["batch_stats"])
    model = build_model(name, shape, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    assert _flat(to_flax(model)["params"]).keys() == _flat(v["params"]).keys()
    for col in v:
        for path, a in _flat(to_flax(model)[col]).items():
            np.testing.assert_array_equal(a, _flat(v[col])[path])
    x = rng.rand(2, *shape).astype(np.float32)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)
