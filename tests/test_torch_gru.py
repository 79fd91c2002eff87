"""The port's GRU recurrence (seld_tpu_torch/ops/gru.py) against the JAX
package's Pallas `gru_scan` (interpret mode on the CPU), its `_gru_scan_ref`
scan, and the `layers.GRU` layer on both of its paths.

Tolerance: 1e-5 abs in f32 — both sides do the same f32 gate arithmetic,
differing only in the order of the U-term sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from seld_tpu.models.layers import GRU as JaxGRU
from seld_tpu.ops.pallas import gru as jax_gru
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.models.layers import GRU
from seld_tpu_torch.ops import gru, kernels

torch.set_num_threads(1)
ATOL = 1e-5


def _scan_inputs(d, t=12, b=8, u=16, seed=0):
    rng = np.random.RandomState(seed)
    xp = rng.randn(d, t, b, 3 * u).astype(np.float32)
    rk = (rng.randn(d, u, 3 * u) / np.sqrt(u)).astype(np.float32)
    rb = (0.1 * rng.randn(d, 3 * u)).astype(np.float32)
    return xp, rk, rb


@pytest.mark.parametrize("d", [1, 2])
def test_gru_scan_ref_matches_pallas_interpret(d):
    xp, rk, rb = _scan_inputs(d)
    with pltpu.force_tpu_interpret_mode():
        want = jax_gru.gru_scan(jnp.asarray(xp), jnp.asarray(rk),
                                jnp.asarray(rb))
    got = gru.gru_scan_ref(*map(torch.from_numpy, (xp, rk, rb)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("d,t", [(1, 12), (2, 12), (2, 60)])
def test_gru_scan_ref_matches_jax_scan(d, t):
    xp, rk, rb = _scan_inputs(d, t=t, seed=1)
    want = jax_gru._gru_scan_ref(jnp.asarray(xp), jnp.asarray(rk),
                                 jnp.asarray(rb))
    got = gru.gru_scan_ref(*map(torch.from_numpy, (xp, rk, rb)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_gru_scan_on_cpu_is_the_plain_version_and_launches_nothing():
    xp, rk, rb = map(torch.from_numpy, _scan_inputs(2, seed=2))
    before = kernels.launch_counts["gru_scan"]
    assert torch.equal(gru.gru_scan(xp, rk, rb), gru.gru_scan_ref(xp, rk, rb))
    assert kernels.launch_counts["gru_scan"] == before


def test_gru_scan_ref_bf16_storage_keeps_f32_math():
    """bf16 x_proj: gates in f32 from the bf16 values, output rounded once
    (the kernel's contract, gru.py:64-67)."""
    xp, rk, rb = map(torch.from_numpy, _scan_inputs(2, seed=3))
    xb = xp.to(torch.bfloat16)
    got = gru.gru_scan_ref(xb, rk, rb)
    assert got.dtype == torch.bfloat16
    want = gru.gru_scan_ref(xb.float(), rk, rb).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_gru_scan_refuses_other_devices():
    xp = torch.empty(2, 4, 8, 48, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        gru.gru_scan(xp, torch.empty(2, 16, 48, device="meta"),
                     torch.empty(2, 48, device="meta"))


@pytest.mark.parametrize("case,exc,match", [
    ("dirs", ValueError, "directions"),
    ("shape", ValueError, "do not match"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("wdtype", TypeError, "rec_kernel dtype"),
    ("contig", ValueError, "contiguous"),
    ("units", ValueError, "U % 4"),
])
def test_cuda_wrapper_checks_raise(case, exc, match):
    """The wrapper's argument checks run before any launch; they are plain
    tensor checks, so they are exercised here on CPU tensors."""
    u = 16
    xp = torch.zeros(2, 5, 8, 3 * u)
    rk = torch.zeros(2, u, 3 * u)
    rb = torch.zeros(2, 3 * u)
    if case == "dirs":
        xp, rk, rb = torch.zeros(3, 5, 8, 48), torch.zeros(3, u, 48), \
            torch.zeros(3, 48)
    elif case == "shape":
        rk = torch.zeros(2, u + 1, 3 * u)
    elif case == "dtype":
        xp = xp.half()
    elif case == "wdtype":
        rk = rk.double()
    elif case == "contig":
        xp = torch.zeros(2, 8, 5, 3 * u).transpose(1, 2)
    elif case == "units":
        xp, rk, rb = torch.zeros(2, 5, 8, 18), torch.zeros(2, 6, 18), \
            torch.zeros(2, 18)
    with pytest.raises(exc, match=match):
        gru._check_cuda_args(xp, rk, rb)


@pytest.mark.parametrize("bidirectional,merge", [
    (True, "mul"), (True, "concat"), (True, "ave"), (True, "sum"),
    (False, "mul")])
def test_gru_layer_matches_jax_layer_both_paths(bidirectional, merge):
    rng = np.random.RandomState(4)
    x = rng.randn(8, 12, 10).astype(np.float32)
    scan = JaxGRU(16, bidirectional=bidirectional, merge_mode=merge,
                  use_pallas=False)
    fused = JaxGRU(16, bidirectional=bidirectional, merge_mode=merge,
                   use_pallas=True)
    v = scan.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    # non-zero biases so both halves of bias [D, 2, 3U] are exercised
    v = jax.tree_util.tree_map(np.asarray, v)
    v["params"]["bias"] = (0.1 * rng.randn(*v["params"]["bias"].shape)
                           ).astype(np.float32)
    want_scan = np.asarray(scan.apply(v, jnp.asarray(x)))
    with pltpu.force_tpu_interpret_mode():
        want_fused = np.asarray(fused.apply(v, jnp.asarray(x)))

    layer = GRU(10, 16, bidirectional=bidirectional, merge_mode=merge)
    layer.load_state_dict(from_flax(v, layer))
    with torch.inference_mode():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want_scan, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_fused, rtol=0, atol=ATOL)


def test_gru_layer_dropout_in_training_is_not_ported():
    layer = GRU(4, 8, bidirectional=True, dropout=0.1).train()
    with pytest.raises(NotImplementedError):
        layer(torch.zeros(2, 3, 4))
    layer.eval()
    assert layer(torch.zeros(2, 3, 4)).shape == (2, 3, 8)
