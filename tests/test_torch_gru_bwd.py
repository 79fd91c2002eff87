"""The port's GRU backward through time (seld_tpu_torch/ops/gru.py:
`gru_scan_bwd_ref`, the `gru_scan` autograd Function) against the JAX
package's `_gru_scan_bwd_impl` (the Pallas BPTT kernel in interpret mode on
the CPU), its `_gru_scan_bwd_ref` (`jax.vjp` of the scan), and `jax.grad`
of the `layers.GRU` layer on both of its paths.

Tolerance: 2e-5 abs + 1e-5 rel in f32. Both sides do the same f32 gate
arithmetic; dRk and dRb are sums over T*B terms of size ~1, which the two
frameworks add in another order (a few f32 ulps of a value ~10).
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
ATOL, RTOL = 2e-5, 1e-5


def _bwd_inputs(d, t=12, b=8, u=16, seed=0):
    """x_proj, rec_kernel, rec_bias, hs (the forward's states) and g."""
    rng = np.random.RandomState(seed)
    xp = rng.randn(d, t, b, 3 * u).astype(np.float32)
    rk = (rng.randn(d, u, 3 * u) / np.sqrt(u)).astype(np.float32)
    rb = (0.1 * rng.randn(d, 3 * u)).astype(np.float32)
    g = rng.randn(d, t, b, u).astype(np.float32)
    hs = np.array(jax_gru._gru_scan_ref(jnp.asarray(xp), jnp.asarray(rk),
                                        jnp.asarray(rb)))
    return xp, rk, rb, hs, g


def _close(got, want):
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [1, 2])
def test_gru_scan_bwd_ref_matches_pallas_interpret(d):
    xp, rk, rb, hs, g = _bwd_inputs(d)
    with pltpu.force_tpu_interpret_mode():
        want = jax_gru._gru_scan_bwd_impl(*map(jnp.asarray,
                                               (xp, rk, rb, hs, g)))
    got = gru.gru_scan_bwd_ref(*map(torch.from_numpy, (xp, rk, rb, hs, g)))
    _close(got, want)


@pytest.mark.parametrize("d,t", [(1, 12), (2, 12), (2, 60)])
def test_gru_scan_bwd_ref_matches_jax_vjp(d, t):
    xp, rk, rb, hs, g = _bwd_inputs(d, t=t, b=3, seed=1)
    want = jax_gru._gru_scan_bwd_ref(*map(jnp.asarray, (xp, rk, rb, g)))
    got = gru.gru_scan_bwd_ref(*map(torch.from_numpy, (xp, rk, rb, hs, g)))
    _close(got, want)


@pytest.mark.parametrize("d", [1, 2])
def test_autograd_through_gru_scan_equals_autograd_through_plain_loop(d):
    """The Function's hand-written backward gives what torch's autograd
    derives from the plain recurrence, and the CPU path launches nothing."""
    xp, rk, rb, _, g = _bwd_inputs(d, t=9, b=5, seed=2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xp, rk, rb)]
    gt = torch.from_numpy(g)
    before = kernels.launch_counts["gru_scan_bwd"]
    got = torch.autograd.grad((gru.gru_scan(*leaves) * gt).sum(), leaves)
    want = torch.autograd.grad((gru.gru_scan_ref(*leaves) * gt).sum(),
                               leaves)
    assert kernels.launch_counts["gru_scan_bwd"] == before
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=RTOL, atol=ATOL)


def test_gru_scan_bwd_on_cpu_is_the_plain_version():
    args = map(torch.from_numpy, _bwd_inputs(2, seed=3))
    args = list(args)
    for a, w in zip(gru.gru_scan_bwd(*args), gru.gru_scan_bwd_ref(*args)):
        assert torch.equal(a, w)


def test_bf16_storage_keeps_f32_math_and_gradient_dtypes():
    """bf16 x_proj/hs/g: the gates and sums are f32 from the bf16 values
    and each output is rounded once; every gradient comes back in its
    argument's dtype, bf16 parameters included (the forward reads them as
    f32)."""
    xp, rk, rb, hs, g = map(torch.from_numpy, _bwd_inputs(2, seed=4))
    xb, hb, gb = (a.to(torch.bfloat16) for a in (xp, hs, g))
    got = gru.gru_scan_bwd_ref(xb, rk, rb, hb, gb)
    want = gru.gru_scan_bwd_ref(xb.float(), rk, rb, hb.float(), gb.float())
    assert [a.dtype for a in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    assert torch.equal(got[0], want[0].to(torch.bfloat16))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])

    leaves = [xb.requires_grad_(), rk.to(torch.bfloat16).requires_grad_(),
              rb.to(torch.bfloat16).requires_grad_()]
    hs_b = gru.gru_scan(*leaves)
    assert hs_b.dtype == torch.bfloat16
    grads = torch.autograd.grad((hs_b.float() * g).sum(), leaves)
    assert all(a.dtype == torch.bfloat16 for a in grads)


@pytest.mark.parametrize("case,exc,match", [
    ("hs_shape", ValueError, "hs .* does not match"),
    ("g_shape", ValueError, "g .* does not match"),
    ("hs_dtype", TypeError, "hs dtype"),
    ("g_dtype", TypeError, "g dtype"),
    ("g_contig", ValueError, "g must be contiguous"),
    ("hs_device", ValueError, "hs is on meta"),
    ("fwd_checks", ValueError, "directions"),
])
def test_cuda_bwd_wrapper_checks_raise(case, exc, match):
    """The backward wrapper's argument checks run before any launch; they
    are plain tensor checks, exercised here on CPU tensors."""
    u = 16
    xp = torch.zeros(2, 5, 8, 3 * u)
    rk, rb = torch.zeros(2, u, 3 * u), torch.zeros(2, 3 * u)
    hs, g = torch.zeros(2, 5, 8, u), torch.zeros(2, 5, 8, u)
    if case == "hs_shape":
        hs = torch.zeros(2, 5, 8, u + 1)
    elif case == "g_shape":
        g = torch.zeros(2, 4, 8, u)
    elif case == "hs_dtype":
        hs = hs.to(torch.bfloat16)
    elif case == "g_dtype":
        g = g.double()
    elif case == "g_contig":
        g = torch.zeros(2, 8, 5, u).transpose(1, 2)
    elif case == "hs_device":
        hs = torch.zeros(2, 5, 8, u, device="meta")
    elif case == "fwd_checks":
        xp = torch.zeros(3, 5, 8, 3 * u)
    with pytest.raises(exc, match=match):
        gru._check_cuda_bwd_args(xp, rk, rb, hs, g)


@pytest.mark.parametrize("bidirectional,merge", [
    (True, "mul"), (True, "concat"), (False, "mul")])
def test_gru_layer_grads_match_jax_grad_both_paths(bidirectional, merge):
    """Gradients of sum(out * w) in the input and every parameter: the
    port's layer against `jax.grad` of the JAX layer on its scan path and
    on its Pallas path (interpret mode)."""
    rng = np.random.RandomState(5)
    x = rng.randn(8, 6, 12).astype(np.float32)
    out_units = 32 if merge == "concat" else 16
    w = rng.randn(8, 6, out_units).astype(np.float32)
    scan = JaxGRU(16, bidirectional=bidirectional, merge_mode=merge,
                  use_pallas=False)
    fused = JaxGRU(16, bidirectional=bidirectional, merge_mode=merge,
                   use_pallas=True)
    v = jax.tree_util.tree_map(np.asarray, scan.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))
    v["params"]["bias"] = (0.1 * rng.randn(*v["params"]["bias"].shape)
                           ).astype(np.float32)

    def loss(module):
        return lambda p, x: jnp.sum(module.apply({"params": p}, x) * w)

    want_scan = jax.grad(loss(scan), argnums=(0, 1))(v["params"], x)
    with pltpu.force_tpu_interpret_mode():
        want_fused = jax.grad(loss(fused), argnums=(0, 1))(v["params"], x)

    layer = GRU(12, 16, bidirectional=bidirectional, merge_mode=merge)
    layer.load_state_dict(from_flax(v, layer))
    xt = torch.from_numpy(x).requires_grad_()
    (layer(xt) * torch.from_numpy(w)).sum().backward()
    for want_p, want_x in (want_scan, want_fused):
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                                   rtol=RTOL, atol=ATOL)
        for name, p in layer.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(),
                                       np.asarray(want_p[name]),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
