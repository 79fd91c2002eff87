"""The Keras legacy-HDF5 import (seld_tpu_torch/compat/keras_h5.py) against
the JAX package's (seld_tpu/compat/keras_h5.py).

1. The parsing and alignment cases of tests/test_tf_import.py:49-212 on
   the port's copies and its own modules.
2. An .h5 file written here with h5py, Keras-named in application order
   (per-base counters, the first of a base unsuffixed, groups listed in
   another order), from seeded weights of a narrow SS5 (conv_temporal) and
   a narrow seldnet: JAX's `import_keras_weights` and the port's give
   equal state_dicts through `bridge.from_flax`, exactly, and the imported
   models equal outputs (atol 1e-5); the port's application order is
   JAX's, module for module.
3. `python -m seld_tpu_torch.import_tf_weights` writes a checkpoint that
   `train.checkpoint.load_variables` serves through a window artifact.
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
from test_torch_model import narrow_ss5, random_variables

from seld_tpu.compat import flax_call_order
from seld_tpu.compat import import_keras_weights as jax_import
from seld_tpu.config import get_model_config
from seld_tpu.models import build_model as jax_build_model
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.compat import (align_entries, call_order,
                                   import_keras_weights, read_legacy_h5)
from seld_tpu_torch.compat.keras_h5 import H5Layer
from seld_tpu_torch.models import build_model
from seld_tpu_torch.models.layers import Conv, LayerNorm

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_ATOL = 1e-5


# ---------------------------------------------------------------------------
# 1. parsing and alignment
# ---------------------------------------------------------------------------
def _conv_layer(name, ci=4, co=8, k=3, rank=4):
    kshape = (k, k, ci, co) if rank == 4 else (k, ci, co)
    return H5Layer(name, [(f"{name}/kernel", np.zeros(kshape, np.float32)),
                          (f"{name}/bias", np.zeros(co, np.float32))])


def test_h5layer_parsing_and_subkinds():
    c = _conv_layer("conv2d_3")
    assert (c.base, c.index, c.kind) == ("conv2d", 3, "conv")
    assert c.subkind() == ("conv", 4)
    assert _conv_layer("conv1d", rank=3).subkind() == ("conv", 3)
    assert _conv_layer("conv2d").index == 0  # unsuffixed = first created

    mha = H5Layer("multi_head_attention__1",
                  [("q/query_kernel", np.zeros((2, 4, 8), np.float32))])
    assert (mha.base, mha.index) == ("multi_head_attention_", 1)
    assert mha.subkind() == ("mha", "plain")
    rel = H5Layer("rel_position_multi_head_attention",
                  [("r/pos_kernel", np.zeros((2, 4, 8), np.float32))])
    assert rel.subkind() == ("mha", "rel")

    gru = H5Layer("bidirectional_2", [
        ("b/forward_gru/gru_cell/kernel", np.zeros((4, 18), np.float32)),
        ("b/forward_gru/gru_cell/recurrent_kernel",
         np.zeros((6, 18), np.float32)),
        ("b/forward_gru/gru_cell/bias", np.zeros((2, 18), np.float32)),
        ("b/backward_gru/gru_cell/kernel", np.zeros((4, 18), np.float32)),
        ("b/backward_gru/gru_cell/recurrent_kernel",
         np.zeros((6, 18), np.float32)),
        ("b/backward_gru/gru_cell/bias", np.zeros((2, 18), np.float32))])
    assert gru.subkind() == ("rnn", 2, 3)  # bidirectional GRU
    lstm = H5Layer("lstm", [
        ("l/kernel", np.zeros((4, 24), np.float32)),
        ("l/recurrent_kernel", np.zeros((6, 24), np.float32)),
        ("l/bias", np.zeros((24,), np.float32))])
    assert lstm.subkind() == ("rnn", 1, 4)

    with pytest.raises(ValueError, match="unsupported Keras layer"):
        H5Layer("embedding_1", [("e/embeddings", np.zeros((4, 4)))])


def test_read_legacy_h5_formats(tmp_path):
    import h5py

    # keras-2 style: model_weights nesting, ':0' suffixes, weightless layers
    path = str(tmp_path / "full_model.hdf5")
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        root.attrs["layer_names"] = np.array(
            [b"input_1", b"conv2d", b"activation", b"dense_1"])
        root.create_group("input_1")
        root.create_group("activation")
        g = root.create_group("conv2d")
        g.attrs["weight_names"] = np.array(
            [b"conv2d/kernel:0", b"conv2d/bias:0"])
        g.create_dataset("conv2d/kernel:0", data=np.ones((3, 3, 4, 8), "f4"))
        g.create_dataset("conv2d/bias:0", data=np.zeros(8, "f4"))
        g = root.create_group("dense_1")
        g.attrs["weight_names"] = np.array([b"dense_1/kernel:0"])
        g.create_dataset("dense_1/kernel:0", data=np.ones((8, 2), "f4"))

    layers = read_legacy_h5(path)
    assert [l.name for l in layers] == ["conv2d", "dense_1"]
    assert layers[0].payload[0].shape == (3, 3, 4, 8)
    assert len(layers[1].payload) == 1  # use_bias=False dense

    bad = str(tmp_path / "not_legacy.h5")
    with h5py.File(bad, "w") as f:
        f.create_group("layers")  # keras-3 .weights.h5 shape
    with pytest.raises(ValueError, match="layer_names"):
        read_legacy_h5(bad)


class _Stack(torch.nn.Module):
    """Modules applied in a row, registered under flax's names."""

    def __init__(self, *mods):
        super().__init__()
        for i, m in enumerate(mods):
            self.add_module(f"{type(m).__name__}_{i}", m)

    def forward(self, x):
        for m in self.children():
            x = m(x)
        return x


def test_align_error_modes():
    m = _Stack(Conv(4, 8, (3, 3)))
    order = call_order(m, torch.zeros(1, 4, 4, 4))
    assert order == [("conv", "Conv_0")]

    conv = _conv_layer("conv2d_5")
    extra = H5Layer("dense",
                    [("d/kernel", np.zeros((8, 2), "f4")),
                     ("d/bias", np.zeros(2, "f4"))])
    with pytest.raises(ValueError, match="left unmapped.*dense"):
        align_entries(m, order, [conv, extra])
    with pytest.raises(ValueError, match="no remaining layer"):
        align_entries(m, order, [extra])
    # wrong conv rank is a different subkind, not a silent mis-map
    with pytest.raises(ValueError, match="no remaining layer"):
        align_entries(m, order, [_conv_layer("conv1d", rank=3)])
    entries = align_entries(m, order, [conv])
    assert entries[0][0] == "conv" and len(entries[0][1]) == 2


def test_align_pops_per_base_creation_order():
    """Two convs created out of file order: suffix sort must win."""
    m = _Stack(Conv(4, 4, (3, 3)), Conv(4, 8, (3, 3)))
    order = call_order(m, torch.zeros(1, 4, 4, 4))
    first = _conv_layer("conv2d_2", ci=4, co=4)
    second = _conv_layer("conv2d_10", ci=4, co=8)
    # file lists them reversed; alignment must still map by creation index
    entries = align_entries(m, order, [second, first])
    assert entries[0][1][0].shape == (3, 3, 4, 4)
    assert entries[1][1][0].shape == (3, 3, 4, 8)


def _ln(name, gamma, beta):
    return H5Layer(name, [(f"{name}/gamma", np.asarray(gamma, "f4")),
                          (f"{name}/beta", np.asarray(beta, "f4"))])


def test_discarded_preln_layernorms_auto_dropped():
    """The reference's pre-LN attention_block creates LayerNorms whose
    outputs it discards; exactly those (bit-exact init) are dropped, and
    ambiguity is a hard error."""
    m = _Stack(LayerNorm(8, epsilon=1e-3))
    order = call_order(m, torch.zeros(1, 4, 8))

    used = _ln("layer_normalization_3", np.full(8, 0.7), np.full(8, 0.2))
    unused0 = _ln("layer_normalization_1", np.ones(8), np.zeros(8))
    unused1 = _ln("layer_normalization_7", np.ones(8), np.zeros(8))
    entries = align_entries(m, order, [unused0, used, unused1])
    assert len(entries) == 1
    np.testing.assert_array_equal(entries[0][1][0], np.full(8, 0.7, "f4"))

    # two excess but only one at exact init -> refuse to guess
    trained = _ln("layer_normalization_9", np.full(8, 1.1), np.zeros(8))
    with pytest.raises(ValueError, match="cannot identify"):
        align_entries(m, order, [unused0, used, trained])


# ---------------------------------------------------------------------------
# 2. a Keras-named file of a whole model
# ---------------------------------------------------------------------------
def narrow_seldnet():
    cfg = copy.deepcopy(get_model_config("seldnet", search_paths=[]))
    cfg["FIRST_ARGS"]["filters"] = [8, 8, 8]
    cfg["SECOND_ARGS"]["units"] = [8, 8]
    cfg["SED_ARGS"]["units"] = [8]
    cfg["DOA_ARGS"]["units"] = [8]
    return cfg


MODELS = {"conv_temporal": ((60, 16, 7), narrow_ss5),
          "seldnet": ((60, 64, 7), narrow_seldnet)}


def _keras_layers(order, variables):
    """[(Keras auto-name, [(weight path, array)])] of every module of the
    JAX model's application order, with per-base counters."""
    counts, out = {}, []

    def name_of(base):
        n = counts.get(base, 0)
        counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"

    def sub(col, path):
        tree = variables.get(col, {})
        for p in path:
            tree = tree[p]
        return tree

    for kind, path in order:
        p = sub("params", path)
        if kind == "conv":
            name = name_of("conv2d" if p["kernel"].ndim == 4 else "conv1d")
            ws = [("kernel", p["kernel"])] + (
                [("bias", p["bias"])] if "bias" in p else [])
        elif kind == "dense":
            name = name_of("dense")
            ws = [("kernel", p["kernel"])] + (
                [("bias", p["bias"])] if "bias" in p else [])
        elif kind == "bn":
            s = sub("batch_stats", path)
            name = name_of("batch_normalization")
            ws = [("gamma", p["scale"]), ("beta", p["bias"]),
                  ("moving_mean", s["mean"]),
                  ("moving_variance", s["var"])]
        elif kind == "ln":
            name = name_of("layer_normalization")
            ws = [("gamma", p["scale"]), ("beta", p["bias"])]
        elif kind == "rnn":
            cell = "lstm" if (p["recurrent_kernel"].shape[2]
                              // p["recurrent_kernel"].shape[1]) == 4 \
                else "gru"
            dirs = p["kernel"].shape[0]
            if dirs == 2:
                name = name_of("bidirectional")
                ws = [(f"{d}_{cell}/{cell}_cell/{leaf}", p[leaf][i])
                      for i, d in enumerate(("forward", "backward"))
                      for leaf in ("kernel", "recurrent_kernel", "bias")]
            else:
                name = name_of(cell)
                ws = [(leaf, p[leaf][0]) for leaf in
                      ("kernel", "recurrent_kernel", "bias")]
        else:
            name = name_of("rel_position_multi_head_attention"
                           if "pos_kernel" in p
                           else "multi_head_attention_")
            ws = list(p.items())
        out.append((name, [(f"{name}/{w}", np.asarray(a, np.float32))
                           for w, a in ws]))
    return out


def write_keras_h5(path, layers, seed=0):
    """A legacy Keras file of `layers`, nested under model_weights, the
    groups listed in a seeded order (the file's order is not creation
    order)."""
    import h5py
    order = np.random.RandomState(seed).permutation(len(layers))
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        root.attrs["layer_names"] = np.array(
            [layers[i][0].encode() for i in order])
        for name, weights in layers:
            g = root.create_group(name)
            g.attrs["weight_names"] = np.array(
                [f"{w}:0".encode() for w, _ in weights])
            for w, a in weights:
                g.create_dataset(f"{w}:0", data=a)


@pytest.fixture(scope="module", params=list(MODELS))
def imported(request, tmp_path_factory):
    """A seeded JAX model's weights written as a Keras-named file; both
    packages' imports of it into freshly initialised models."""
    name = request.param
    shape, config = MODELS[name]
    cfg = config()
    jm = jax_build_model(name, shape, cfg)
    x = jnp.zeros((1, *shape), jnp.float32)
    seeded = jax.tree_util.tree_map(np.asarray, random_variables(jm, shape))
    order = flax_call_order(jm, seeded, x, train=False)
    path = str(tmp_path_factory.mktemp("h5") / f"{name}.hdf5")
    write_keras_h5(path, _keras_layers(order, seeded))
    fresh = jm.init({"params": jax.random.PRNGKey(0)}, x, train=False)
    want = jax_import(jm, fresh, path, x)
    model = build_model(name, shape, cfg, seed=3, device="cpu")
    got = import_keras_weights(model, path, torch.zeros(1, *shape))
    return {"name": name, "shape": shape, "cfg": cfg, "jm": jm,
            "order": order, "want": want, "got": got, "model": model,
            "seeded": seeded, "path": path}


def test_port_call_order_is_jax_application_order(imported):
    """The hooks record the modules in flax's application order, module
    for module (the Keras names' creation order rests on it), in eval mode
    and in training mode, where SS5's stem is the fused op that calls
    neither its Conv nor its BatchNorm."""
    want = [(k, ".".join(p)) for k, p in imported["order"]]
    x = torch.zeros(2, *imported["shape"])
    assert call_order(imported["model"], x) == want
    assert call_order(copy.deepcopy(imported["model"]), x, train=True) == want


def test_import_equals_jax_import_exactly(imported):
    """Every parameter and statistic the port imports equals JAX's
    import, bridged, bit for bit, and both are the file's values."""
    want = from_flax(jax.tree_util.tree_map(np.asarray, imported["want"]),
                     imported["model"])
    got = imported["got"]
    assert set(got) == set(want)
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    seeded = from_flax(imported["seeded"], imported["model"])
    for key, w in seeded.items():
        assert torch.equal(got[key], w), key


def test_imported_models_give_equal_outputs(imported):
    """The port's model loaded with its import and JAX's model on JAX's
    import, in eval mode on one seeded batch: outputs within 1e-5."""
    model = imported["model"]
    model.load_state_dict(imported["got"])
    x = np.random.RandomState(4).randn(2, *imported["shape"]).astype(
        np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    want = imported["jm"].apply(imported["want"], jnp.asarray(x),
                                train=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=OUT_ATOL)


def test_a_layer_the_model_lacks_is_refused(imported, tmp_path):
    """A file with one more dense layer than the model: refused with its
    name, before anything is written."""
    layers = read_legacy_h5(imported["path"])
    extra = [(l.name, l.weights) for l in layers] + [
        ("dense_99", [("dense_99/kernel", np.zeros((4, 2), "f4"))])]
    path = str(tmp_path / "extra.hdf5")
    write_keras_h5(path, extra)
    with pytest.raises(ValueError, match="left unmapped.*dense_99"):
        import_keras_weights(imported["model"], path,
                             torch.zeros(1, *imported["shape"]))


# ---------------------------------------------------------------------------
# 3. the command line
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("imported", ["conv_temporal"], indirect=True)
def test_cli_writes_a_checkpoint_the_inference_tools_load(imported,
                                                          tmp_path):
    """`python -m seld_tpu_torch.import_tf_weights` (scripts/
    import_tf_weights.py's flags) writes a checkpoint and its meta;
    `load_variables` loads it into a new model, whose window artifact
    scores a window as the imported model does; a second run refuses the
    existing output."""
    from seld_tpu_torch.inference import export_window, load_exported
    from seld_tpu_torch.train.checkpoint import load_variables
    cfg_path = tmp_path / "narrow.json"
    cfg_path.write_text(json.dumps(imported["cfg"]))
    out = str(tmp_path / "imported" / "ss5")
    argv = [sys.executable, "-m", "seld_tpu_torch.import_tf_weights",
            "--weights", imported["path"], "--model_config", str(cfg_path),
            "--input_shape", "60,16,7", "--out", out, "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout
    meta = json.loads(open(out + ".meta.json").read())
    assert meta["model"] == "conv_temporal" and meta["n_classes"] == 12
    shape = imported["shape"]
    model = load_variables(out, build_model("conv_temporal", shape,
                                            imported["cfg"], seed=9,
                                            device="cpu"))
    for key, w in imported["got"].items():
        assert torch.equal(model.state_dict()[key], w), key
    x = np.random.RandomState(5).randn(2, *shape).astype(np.float32)
    art = load_exported(export_window(model, str(tmp_path / "w.npz"),
                                      batch=2), device="cpu")
    sed, doa = art.call(torch.from_numpy(x))
    imported["model"].load_state_dict(imported["got"])
    with torch.no_grad():
        ws, wd = imported["model"].eval()(torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(sed), ws.numpy(), atol=OUT_ATOL)
    np.testing.assert_allclose(np.asarray(doa), wd.numpy(), atol=OUT_ATOL)
    again = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=300)
    assert again.returncode != 0 and "already exists" in again.stderr
