"""The model zoo in the port: every config of seld_tpu/config/zoo.py builds
through seld_tpu_torch.models.build_model (resnet_gru through
conv_temporal with first_pool_size [5, 1], as tests/test_models.py builds
it), with flax's parameter tree at full width, and each family's narrowed
config runs the forward of seld_tpu's twin on the same weights.

  - full width (300, 64, 7): the state_dict's keys and shapes equal the
    flax tree of `jax.eval_shape(model.init, ...)` (nothing compiles), the
    parameter counts are equal, and `bridge.from_flax` loads that tree
    into the model with no leaf left over or missing;
  - narrowed (every width cut, block types, depths, kernels, strides and
    pools kept; input (60, 32, 7), B=2, random weights and BatchNorm
    statistics through the bridge): sed and doa in eval mode to 1e-4 abs
    in f32 — the same formulas, the summation order inside convs and
    products differing between XLA and PyTorch (~1e-6).
"""
import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import random_variables

from seld_tpu.config import get_model_config as jax_get_model_config
from seld_tpu.models import build_model as jax_build_model
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.config import get_model_config
from seld_tpu_torch.models import build_model

torch.set_num_threads(1)
FULL_SHAPE = (300, 64, 7)
NARROW_SHAPE = (60, 32, 7)
FORWARD_ATOL = 1e-4

# (zoo config, model), as tests/test_models.py pairs them
ZOO = [("seldnet", "seldnet"), ("seldnet_v1", "seldnet_v1"),
       ("SS5", "conv_temporal"), ("dense_gru", "seldnet"),
       ("resnet_gru", "conv_temporal"), ("resnet50_gru", "seldnet"),
       ("xception_gru", "seldnet"), ("Condseldnet", "seldnet"),
       ("conv_temp", "conv_temporal")]
LEGACY = [z for z in ZOO if z[0] != "SS5"]


def zoo_config(name: str) -> dict:
    cfg = copy.deepcopy(get_model_config(name, search_paths=[]))
    if name == "resnet_gru":
        cfg.setdefault("first_pool_size", [5, 1])
    return cfg


def narrow_zoo(name: str) -> dict:
    """`name`'s zoo config with every width cut: conv filters 2-16, GRU and
    head units 16; block types, depths (some cut), kernels, strides and
    pools are the config's."""
    cfg = zoo_config(name)
    body = "SECOND" if "SECOND" in cfg else max(
        k for k in cfg if k.startswith("BLOCK") and not k.endswith("_ARGS"))
    cfg[f"{body}_ARGS"] = {"units": [16, 16], "dropout_rate": 0.0}
    cfg["SED_ARGS"]["units"] = [16]
    cfg["DOA_ARGS"]["units"] = [16]
    first = cfg.get("FIRST_ARGS")
    if name in ("seldnet", "seldnet_v1", "Condseldnet"):
        first["filters"] = [8, 8, 8]
    elif name == "dense_gru":
        first.update(filters=8, block_num=[2, 3])
    elif name == "resnet50_gru":
        first.update(filters=4, block_num=[1, 2, 1, 1])
    elif name == "xception_gru":
        first.update(filters=4, block_num=2)
    elif name == "conv_temp":
        cfg["filters"] = 8
        cfg["BLOCK0_ARGS"].update(filters=4, depth=2)
        cfg["BLOCK1_ARGS"].update(filters=16)
        cfg["BLOCK2_ARGS"].update(growth_rate=4, depth=2)
        cfg["BLOCK3_ARGS"].update(filters=8, depth=2)
    elif name == "resnet_gru":
        cfg["filters"] = 8
        for i, (f, d) in enumerate(((2, 2), (4, 1), (4, 1), (4, 1))):
            cfg[f"BLOCK{i}_ARGS"].update(filters=f, depth=d)
    return cfg


def _flax_shapes(model_name, cfg, shape):
    jm = jax_build_model(model_name, shape, cfg)
    return jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *shape)),
        train=False))


def _flat_shapes(tree):
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda path, s: out.__setitem__(
            ".".join(p.key for p in path[1:]), tuple(s.shape)), tree)
    return out


def test_zoo_list_is_the_jax_zoo():
    from seld_tpu.config.zoo import MODEL_CONFIGS
    assert sorted(name for name, _ in ZOO) == sorted(MODEL_CONFIGS)


@pytest.mark.parametrize("name,model_name", ZOO, ids=[z[0] for z in ZOO])
def test_full_width_parameters_equal_the_flax_tree(name, model_name):
    cfg = zoo_config(name)
    assert cfg == {**jax_get_model_config(name, search_paths=[]),
                   **({"first_pool_size": [5, 1]}
                      if name == "resnet_gru" else {})}
    shapes = _flax_shapes(model_name, cfg, FULL_SHAPE)
    model = build_model(model_name, FULL_SHAPE, cfg, device="cpu")
    want = _flat_shapes(shapes)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    # the flax tree loads with nothing left over or missing
    variables = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    model.load_state_dict(from_flax(variables, model))
    assert all(bool((v == 0.5).all()) for v in model.state_dict().values())


@pytest.mark.parametrize("name,model_name", LEGACY,
                         ids=[z[0] for z in LEGACY])
def test_narrow_forward_matches_jax(name, model_name):
    cfg = narrow_zoo(name)
    jm = jax_build_model(model_name, NARROW_SHAPE, cfg)
    v = random_variables(jm, NARROW_SHAPE)
    x = np.random.RandomState(2).randn(2, *NARROW_SHAPE).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    model = build_model(model_name, NARROW_SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    n_classes = cfg.get("n_classes", 14)
    assert got[0].shape == (2, 12, n_classes)
    assert got[1].shape == (2, 12, 3 * n_classes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FORWARD_ATOL)


def test_seldnet_v1_gates_doa_with_sed():
    """seldnet_v1 on seldnet's weights: sed equal, doa tanh(doa * sed x 3)."""
    cfg = narrow_zoo("seldnet")
    a = build_model("seldnet", NARROW_SHAPE, cfg, seed=3, device="cpu")
    b = build_model("seldnet_v1", NARROW_SHAPE, cfg, seed=3, device="cpu")
    x = torch.from_numpy(np.random.RandomState(4).randn(
        2, *NARROW_SHAPE).astype(np.float32))
    with torch.inference_mode():
        (sa, da), (sb, db) = a(x), b(x)
    torch.testing.assert_close(sb, sa, rtol=0, atol=0)
    torch.testing.assert_close(db, torch.tanh(da * torch.cat([sa] * 3, -1)),
                               rtol=0, atol=1e-7)


def test_training_cli_trains_its_default_seldnet(tmp_path):
    """`python -m seld_tpu_torch.train` with no --model trains seldnet (the
    flag table's default) on the rehearsal's TINY_CONFIG: one epoch on a
    synthesized feat_label tree on the CPU, a best-score checkpoint under
    the seldnet run name."""
    from seld_tpu_torch.dress_rehearsal import TINY_CONFIG, synthesize_dataset

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    synthesize_dataset(str(tmp_path / "data"), 2, 1, 60, n_classes=12)
    (tmp_path / "model_config").mkdir()
    with open(tmp_path / "model_config" / "tiny.json", "w") as f:
        json.dump(TINY_CONFIG, f)
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-m", "seld_tpu_torch.train", "--name", "t",
         "--model_config", "tiny", "--abspath", str(tmp_path / "data"),
         "--batch", "2", "--loop_time", "1", "--epoch", "1",
         "--eval_every", "0", "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "best val seld score" in proc.stdout
    runs = os.listdir(tmp_path / "saved_model")
    assert len(runs) == 1 and runs[0].startswith("seldnet_tiny_")
    assert any(f.startswith("bestscore_")
               for f in os.listdir(tmp_path / "saved_model" / runs[0]))


def test_window_artifact_and_clip_scoring_take_the_zoo(tmp_path):
    """The model-agnostic paths take a SELDNet: a window artifact of narrow
    xception_gru reloads and answers as the model does, and the exact
    sliding-window path scores a one-window clip (with and without
    `variables`) as the model's forward."""
    from seld_tpu_torch.inference import export_window, load_exported
    from seld_tpu_torch.inference.ensemble import ensemble_outputs

    model = build_model("seldnet", NARROW_SHAPE, narrow_zoo("xception_gru"),
                        seed=5, device="cpu")
    x = torch.from_numpy(np.random.RandomState(6).randn(
        3, *NARROW_SHAPE).astype(np.float32))
    with torch.inference_mode():
        want = [w.numpy() for w in model(x)]
    path = export_window(model, str(tmp_path / "xception.npz"))
    art = load_exported(path, device="cpu")
    for g, w in zip(art.call(x), want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    for variables in (None, dict(model.state_dict())):
        (sed, doa), = ensemble_outputs(model, [x[0]], win_size=60,
                                       batch_size=4, variables=variables)
        np.testing.assert_allclose(sed.numpy(), want[0][0], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(doa.numpy(), want[1][0], rtol=0,
                                   atol=1e-6)
