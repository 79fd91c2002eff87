"""The port's whole SS5 forward (seld_tpu_torch/models/models.py) against
seld_tpu's `ConvTemporal.apply(train=False)`, on sed and doa.

Tolerance: 1e-5 abs / 1e-4 rel in f32. Both sides run the same f32 formulas
layer by layer (asymmetric SAME padding, eps 1e-3 norms, pre-scaled MHA
queries, Keras GRU gates); only the summation order inside convs and
products differs between XLA and PyTorch, which moves outputs by ~1e-6.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import get_model_config
from seld_tpu.models import build_model as jax_build_model
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.models import build_model

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4


def narrow_ss5() -> dict:
    """SS5 with every width cut (stem 8, mother 16, dense 32, conformer key
    8, GRU 16); block types, depths, kernels, strides and the head layout
    are SS5's."""
    cfg = copy.deepcopy(get_model_config("SS5", search_paths=[]))
    cfg["filters"] = 8
    cfg["BLOCK0_ARGS"]["filters1"] = 16
    cfg["BLOCK1_ARGS"]["units"] = 32
    cfg["BLOCK2_ARGS"]["key_dim"] = 8
    cfg["SED_ARGS"]["key_dim"] = 8
    cfg["DOA_ARGS"]["units"] = 16
    return cfg


def random_variables(model, input_shape, seed=1):
    """numpy variables of the flax model's shapes: kernels ~ N(0, 1/fan_in),
    non-zero biases, scales near 1, random BatchNorm running stats (so eval
    BN is not the identity). Drawn from shapes alone — no flax init."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *input_shape)),
        train=False))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("mean", "bias") or name.endswith("_bias"):
            a = 0.2 * rng.randn(*s.shape)
        elif name == "var":
            a = 0.5 + rng.rand(*s.shape)
        elif name == "scale":
            a = 1.0 + 0.2 * rng.randn(*s.shape)
        else:
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(cfg, input_shape, batch, seed=0):
    jm = jax_build_model("conv_temporal", input_shape, cfg)
    v = random_variables(jm, input_shape)
    x = np.random.RandomState(seed).randn(batch, *input_shape).astype(
        np.float32)
    sed, doa = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        v, jnp.asarray(x))
    model = build_model("conv_temporal", input_shape, cfg, device="cpu")
    model.load_state_dict(from_flax(v, model))
    return model, x, np.asarray(sed), np.asarray(doa)


def test_narrow_ss5_matches_jax():
    model, x, want_sed, want_doa = _pair(narrow_ss5(), (60, 16, 7), 8)
    with torch.inference_mode():
        sed, doa = model(torch.from_numpy(x))
    assert sed.shape == (8, 12, 12) and doa.shape == (8, 12, 36)
    np.testing.assert_allclose(sed.numpy(), want_sed, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(doa.numpy(), want_doa, rtol=RTOL, atol=ATOL)


def test_full_width_ss5_matches_jax():
    """SS5 at its published widths on one [300, 64, 7] window pair."""
    cfg = get_model_config("SS5", search_paths=[])
    model, x, want_sed, want_doa = _pair(cfg, (300, 64, 7), 2, seed=3)
    with torch.inference_mode():
        sed, doa = model(torch.from_numpy(x))
    assert sed.shape == (2, 60, 12) and doa.shape == (2, 60, 36)
    np.testing.assert_allclose(sed.numpy(), want_sed, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(doa.numpy(), want_doa, rtol=RTOL, atol=ATOL)


def test_build_model_seeded_eval_and_param_count():
    cfg = get_model_config("SS5", search_paths=[])
    a = build_model("conv_temporal", (300, 64, 7), cfg, seed=0, device="cpu")
    b = build_model("conv_temporal", (300, 64, 7), cfg, seed=0, device="cpu")
    c = build_model("conv_temporal", (300, 64, 7), cfg, seed=1, device="cpu")
    assert not a.training
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["Conv2DBN_0.Conv_0.kernel"],
                           sc["Conv2DBN_0.Conv_0.kernel"])
    jm = jax_build_model("conv_temporal", (300, 64, 7), cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 300, 64, 7)),
        train=False))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in a.parameters()) == n_jax


def test_unknown_model_and_unported_stage_blocks():
    from seld_tpu_torch.config import get_model
    with pytest.raises(KeyError, match="unknown model"):
        get_model("seldnet_not_here")
    # scan_depth, once refused, builds flax's nn.scan tree (one body under
    # `scan`, its leaves stacked over the depth)
    cfg = narrow_ss5()
    cfg["BLOCK2_ARGS"]["scan_depth"] = True
    model = build_model("conv_temporal", (60, 16, 7), cfg, device="cpu")
    depth = cfg["BLOCK2_ARGS"]["depth"]
    scanned = {k: v for k, v in model.state_dict().items()
               if k.startswith("ConformerEncoderBlock_0.scan.")}
    assert scanned and all(v.shape[0] == depth for v in scanned.values())
