"""The port's weight-only quantisation (seld_tpu_torch/inference/quantize.py)
against the JAX package's `quantize_tree`, `dequantize_tree`,
`quantized_apply` and `quantization_report` on the same bridged weights,
and quantised artifacts (inference/export.py) of both units.

Setup: narrow SS5 (tests/test_torch_model.py::narrow_ss5) with random
variables. int8 words and scales are compared exactly (the same f32 ops:
amax / 127, a division, round half to even, a clip), as are the bf16
casts; the dequantised forward against `quantized_apply` to 1e-5 abs /
1e-4 rel (the model test's f32 tolerance).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import narrow_ss5, random_variables

from seld_tpu.inference import quantize as jq
from seld_tpu.models import build_model as jax_build_model
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.inference import ensemble as tens
from seld_tpu_torch.inference import quantize as tq
from seld_tpu_torch.inference.export import (export_clip_fast,
                                             export_window, load_exported)
from seld_tpu_torch.models import build_model

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4
SHAPE = (60, 16, 7)


@pytest.fixture(scope="module")
def pair():
    cfg = copy.deepcopy(narrow_ss5())
    cfg["n_classes"] = 12
    jm = jax_build_model("conv_temporal", SHAPE, cfg)
    v = random_variables(jm, SHAPE, seed=3)
    model = build_model("conv_temporal", SHAPE, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    return jm, v, model


def _flat_jax(tree):
    """A JAX (q)tree keyed by state_dict name ("A_0.B.kernel")."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jq.QTensor))[0]
    return {".".join(k.key for k in path[1:]): leaf for path, leaf in leaves}


def _x(b=3, seed=0):
    return np.random.RandomState(seed).randn(b, *SHAPE).astype(np.float32)


@pytest.mark.parametrize("min_size", [1024, 64])
def test_int8_words_and_scales_equal_jax(pair, min_size):
    _, v, model = pair
    want = _flat_jax(jq.quantize_tree(v, "int8", min_size=min_size))
    got = tq.quantize_tree(model.state_dict(), "int8", min_size=min_size)
    assert set(got) == set(want)
    n_q = 0
    for key, w in want.items():
        g = got[key]
        assert isinstance(g, tq.QTensor) == isinstance(w, jq.QTensor), key
        if isinstance(w, jq.QTensor):
            n_q += 1
            assert g.q.dtype == torch.int8 and g.dtype == w.dtype
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(g.scale.numpy(),
                                          np.asarray(w.scale))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert n_q > 0
    deq = tq.dequantize_tree(got)
    want_deq = _flat_jax(jq.dequantize_tree(jq.quantize_tree(
        v, "int8", min_size=min_size)))
    for key, w in want_deq.items():
        assert deq[key].dtype == torch.float32
        np.testing.assert_array_equal(deq[key].numpy(), np.asarray(w))


def test_bfloat16_casts_every_float_entry_like_jax(pair):
    _, v, model = pair
    want = _flat_jax(jq.quantize_tree(v, "bfloat16"))
    got = tq.quantize_tree(model.state_dict(), "bfloat16")
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == torch.bfloat16, key
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("mode", ["int8", "bfloat16"])
def test_dequantized_forward_matches_quantized_apply(pair, mode):
    jm, v, model = pair
    fn, _ = jq.quantized_apply(jm.apply, v, mode)
    x = _x()
    want = fn(jnp.asarray(x), train=False)
    deq = copy.deepcopy(model)
    deq.load_state_dict(tq.dequantize_tree(
        tq.quantize_tree(model.state_dict(), mode)))
    with torch.inference_mode():
        got = deq(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["int8", "bfloat16"])
def test_quantization_report_matches_jax(pair, mode):
    _, v, model = pair
    state = model.state_dict()
    got = tq.quantization_report(state, tq.quantize_tree(state, mode))
    want = jq.quantization_report(v, jq.quantize_tree(v, mode))
    assert {k: got[k] for k in ("bytes_before", "bytes_after",
                                "n_quantized_leaves")} == \
        {k: want[k] for k in ("bytes_before", "bytes_after",
                              "n_quantized_leaves")}
    assert got["max_abs_error"] == pytest.approx(want["max_abs_error"],
                                                 rel=1e-6)


def test_unknown_mode_and_the_error_bound(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="quantize mode"):
        tq.quantize_tree(model.state_dict(), "int4")
    w = torch.randn(64, 32)
    w[:, 3] = 0.0                         # an all-zero channel: scale 1
    q = tq.quantize_tree({"w": w}, "int8")["w"]
    assert q.scale[0, 3] == 1.0 and (q.q[:, 3] == 0).all()
    err = (tq.dequantize_tree({"w": q})["w"] - w).abs()
    assert (err <= q.scale / 2 + 1e-7).all()


@pytest.mark.parametrize("mode", ["int8", "bfloat16"])
def test_quantized_artifacts_store_the_words_and_dequantize_at_load(
        pair, mode, tmp_path):
    """A quantised window artifact holds the int8 words and scales (or the
    bf16 bits), is smaller than the f32 one and computes what the
    dequantised model computes; so does a quantised clip artifact."""
    _, _, model = pair
    deq = copy.deepcopy(model)
    deq.load_state_dict(tq.dequantize_tree(
        tq.quantize_tree(model.state_dict(), mode)))
    f32 = export_window(model, str(tmp_path / "f32.npz"))
    path = export_window(model, str(tmp_path / f"{mode}.npz"),
                         quantize=mode)
    with np.load(path) as z:
        kinds = {k.rsplit("#", 1)[-1] if "#" in k else "f32": z[k].dtype
                 for k in z.files}
    if mode == "int8":
        assert kinds["q"] == np.int8 and kinds["scale"] == np.float32
    else:
        assert set(kinds) == {"bf16"}
    art = load_exported(path, device="cpu")
    assert art.meta["quantize"] == mode
    assert art.meta["bytes"] < load_exported(f32, "cpu").meta["bytes"]
    x = torch.from_numpy(_x(seed=1))
    with torch.inference_mode():
        want = deq(x)
    for g, w in zip(art.call(x), want):
        np.testing.assert_array_equal(g, w.numpy())

    clip = torch.from_numpy(np.random.RandomState(2).randn(
        120, *SHAPE[1:]).astype(np.float32))
    cpath = export_clip_fast(model, str(tmp_path / f"clip_{mode}.npz"), 120,
                             win_size=60, step_size=5, time_down=5,
                             quantize=mode)
    want = tens.ensemble_outputs(deq, [clip], win_size=60, step_size=5,
                                 fast=True)[0]
    for g, w in zip(load_exported(cpath, "cpu").call(clip), want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-6, rtol=0)
