"""The port's GRU backward through time (seld_tpu_torch/ops/gru.py:
`gru_scan_bwd_ref`, the `gru_scan` autograd Function) against the JAX
package's `_gru_scan_bwd_impl` (the Pallas BPTT kernel in interpret mode on
the CPU), its `_gru_scan_bwd_ref` (`jax.vjp` of the scan), and `jax.grad`
of the `layers.GRU` layer on both of its paths.

Tolerance: 2e-5 abs + 1e-5 rel in f32. Both sides do the same f32 gate
arithmetic; dRk and dRb are sums over T*B terms of size ~1, which the two
frameworks add in another order (a few f32 ulps of a value ~10). The
CUDA kernel's tile plan (`_bwd_plan`) is checked by its own index
arithmetic, and a CPU model of its decomposition against the plain
version at the same tolerance.
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
    ("u_odd", ValueError, "U % 4"),
    ("u_too_wide", ValueError, r"4 <= U <= 256"),
])
def test_cuda_bwd_wrapper_checks_raise(case, exc, match):
    """The backward wrapper's argument checks and its plan run before any
    library load or launch; they are plain tensor checks, exercised here on
    CPU tensors."""
    u = {"u_odd": 18, "u_too_wide": 164}.get(case, 16)
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
    loaded = dict(kernels._libs)
    with pytest.raises(exc, match=match):
        gru._gru_scan_bwd_cuda(xp, rk, rb, hs, g)
    assert kernels._libs == loaded


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


def _bwd_states(plan, d, b, u):
    """The (direction, row, unit) states whose dh the backward recurrence's
    lanes finish on `plan`, by csrc/gru_bwd.cu's own index arithmetic: CTA
    (blockIdx.x, d) is rank blockIdx.x % C of tile blockIdx.x // C; thread
    tid is lane tid % S of group tid // S, which owns the CTA's units
    [NU grp, NU (grp + 1)); lane l finishes entries e in [l R, (l + 1) R),
    R = NU BT / S: row e // NU of the tile, unit e % NU of the group. The
    streamed recurrence: thread tid of pass p owns CTA unit p threads + tid
    for all the tile's kStreamBT rows. The resident one:
    `_resident_states`."""
    if plan.variant in gru._BWD_RES:
        return _resident_states(plan, b, u)[0]
    if plan.variant == gru._BWD_STREAM:
        # group 0's thread l of KS groups of UW: CTA units l, l + UW, ...
        bt, maxt = gru._STREAM[:2]
        uc = u // plan.c
        ks, uw = gru._stream_split(uc)
        assert plan.bt == bt and plan.threads == ks * uw <= maxt
        return [(dd, (bx // plan.c) * bt + j, bx % plan.c * uc + base + l)
                for dd in range(plan.grid[1]) for bx in range(plan.grid[0])
                for base in range(0, uc, uw) for l in range(uw)
                if base + l < uc
                for j in range(min(bt, b - (bx // plan.c) * bt))]
    s, ni, bt, nu, maxt = gru._BWD_VARIANTS[plan.variant]
    assert plan.bt == bt and u <= 4 * s * ni and (nu * bt) % s == 0
    uc, r = u // plan.c, nu * bt // s
    assert nu % r == 0           # a lane's states: consecutive units, a row
    states = []
    for dd in range(plan.grid[1]):
        for bx in range(plan.grid[0]):
            rank, b0 = bx % plan.c, (bx // plan.c) * bt
            rows = min(bt, b - b0)
            for tid in range(plan.threads):
                lane, grp = tid % s, tid // s
                for j in range(r):
                    e = lane * r + j
                    if grp * nu < uc and e // nu < rows:
                        states.append((dd, b0 + e // nu,
                                       rank * uc + grp * nu + e % nu))
    return states


def _resident_states(plan, b, u):
    """The resident recurrence by csrc/gru_bwd.cu's index arithmetic:
    (the states whose dh its threads finish, the slot writes its lanes make,
    the slot reads its states make). CTA (blockIdx.x, d) is rank
    blockIdx.x % C of tile blockIdx.x // C and owns units [rank ucw, rank
    ucw + ucw) below U; thread tid finishes unit tid % ucw of rows tid //
    ucw + 8 i and reads slots[c][row][unit] of every rank c; in the
    product, lane tid % S of group tid // S sums output units 4 (tid // S)
    .. + 3 over the CTA's k' and writes rows p RP + l RP / S + j of each
    pass p into the owner's slots[rank][row][unit]."""
    c, s, nr, ns, most, rp = gru._BWD_RESIDENT[plan.variant - gru._BWD_RES[0]]
    ucw = gru._res_cta_units(u, c)
    nt = c * ucw // gru._GROUP_UNITS * s
    assert plan.c == c and plan.threads == nt == 8 * ucw and nt % 32 == 0
    assert 3 * ucw <= 4 * s * (nr + ns) and rp % s == 0
    assert plan.bt % 8 == 0 and plan.bt <= most
    r = rp // s
    states, writes, reads = [], [], []
    for dd in range(plan.grid[1]):
        for bx in range(plan.grid[0]):
            rank, tile = bx % c, bx // c
            b0 = tile * plan.bt
            rows = min(plan.bt, b - b0)
            uc = max(0, min(ucw, u - rank * ucw))
            for tid in range(nt):
                uu, brow = tid % ucw, tid // ucw
                for i in range(most // 8):
                    row = brow + 8 * i
                    if row < plan.bt and uu < uc and row < rows:
                        states.append((dd, b0 + row, rank * ucw + uu))
                        reads += [(dd, tile, src, rank, row, uu)
                                  for src in range(c)]
                lane, uo0 = tid % s, gru._GROUP_UNITS * (tid // s)
                if uo0 >= u:
                    continue
                for p in range(-(-rows // rp)):
                    for j in range(r):
                        row = p * rp + lane * r + j
                        writes += [(dd, tile, rank, (uo0 + o) // ucw, row,
                                    (uo0 + o) % ucw)
                                   for o in range(gru._GROUP_UNITS)]
    return states, writes, reads


@pytest.mark.parametrize("u", [16, 64, 128, 144, 152, 192, 208, 256])
@pytest.mark.parametrize("b", [1, 3, 8, 17, 32, 64, 256])
def test_bwd_plan_covers_every_state_exactly_once(b, u):
    """Every (direction, row, unit) once; clusters of at most 8 CTAs that
    split U into whole lane groups; blocks within the variant's thread
    limit, the Rk slice of a lane within kMaxWeights registers, and the
    threads of a block within the SM's 65,536 registers at 255 each."""
    plan = gru._bwd_plan(2, b, u)
    s, ni, bt, nu, maxt = gru._BWD_VARIANTS[plan.variant]
    assert plan.c in gru._CLUSTERS and plan.c <= 8
    assert u % plan.c == 0 and (u // plan.c) % nu == 0
    assert plan.grid[0] % plan.c == 0 and plan.grid[1] == 2
    assert plan.threads % 32 == 0 and plan.threads <= maxt
    assert plan.threads * 255 <= 65536
    assert nu * 3 * ni * 4 <= gru._BWD_MAX_WEIGHTS
    states = _bwd_states(plan, 2, b, u)
    assert len(states) == len(set(states)) == 2 * b * u


@pytest.mark.parametrize("u", [260, 384, 388, 512, 2056])
@pytest.mark.parametrize("b", [1, 17, 256])
def test_streamed_bwd_plan_covers_every_state_exactly_once(b, u):
    """The streamed recurrence (the plan past U = 512, forced below it):
    clusters of 8 (or 4 where 8 does not divide U), a thread per CTA unit
    up to kStreamThreads (U = 2056: 257 units a CTA, walked in two
    passes)."""
    plan = gru._bwd_plan(2, b, u, variant=gru._BWD_STREAM)
    assert plan.variant == gru._BWD_STREAM
    assert (gru._bwd_plan(2, b, u).variant == gru._BWD_STREAM) == (u > 512)
    assert plan.c == (8 if u % 8 == 0 else 4) and u % plan.c == 0
    uw = min(256, -(-(u // plan.c) // 32) * 32)
    assert plan.threads == uw * min(256 // uw, 4)
    states = _bwd_states(plan, 2, b, u)
    assert len(states) == len(set(states)) == 2 * b * u


@pytest.mark.parametrize("u", [260, 384, 388, 512])
@pytest.mark.parametrize("b", [3, 17, 256])
def test_resident_bwd_plan_covers_every_state_exactly_once(b, u):
    """Past U = 256 up to 512 the resident recurrence: every (direction,
    row, unit) state once, and every slot a state reads (one a rank of its
    cluster) written exactly once a step, and no other."""
    plan = gru._bwd_plan(2, b, u)
    assert plan.variant in gru._BWD_RES
    states, writes, reads = _resident_states(plan, b, u)
    assert len(states) == len(set(states)) == 2 * b * u
    assert len(writes) == len(set(writes))
    assert set(reads) <= set(writes) and len(reads) == len(set(reads))
    # the rest are padding rows of a ragged tile or padding units
    extra = set(writes) - set(reads)
    assert all(row >= min(plan.bt, b - tile * plan.bt) or
               owner * gru._res_cta_units(u, plan.c) + unit >= u
               for _, tile, _, owner, row, unit in extra)


def _resident_model(xp, rk, rb, hs, g, c):
    """Plain-torch model of the resident recurrence's product: CTA `rank`
    of c (4 ceil(U / 4c) units each, the last ones fewer) sums dhp @ Rk^T
    over its own units' dhp only (k' = gate ucw + unit), for every output
    unit, and each unit's owner adds the c partial sums in rank order, as
    csrc/gru_bwd.cu's slots do. Returns dx_proj; tests only."""
    d_dirs, t_steps, b, k = xp.shape
    u = k // 3
    ucw = gru._res_cta_units(u, c)
    dxp = torch.empty_like(xp)
    for d in range(d_dirs):
        order = list(gru._step_order(d, t_steps))
        # W[rank][k', u'] = Rk[u'][gate U + rank ucw + unit]
        w = torch.zeros(c, 3 * ucw, u)
        for rank in range(c):
            for gate in range(3):
                for unit in range(min(ucw, u - rank * ucw)):
                    w[rank, gate * ucw + unit] = \
                        rk[d, :, gate * u + rank * ucw + unit]
        zdh = torch.zeros(b, u)
        parts = torch.zeros(c, b, u)
        for p in range(t_steps - 1, -1, -1):
            t = order[p]
            h_prev = hs[d, order[p - 1]] if p > 0 else torch.zeros(b, u)
            hp = h_prev @ rk[d] + rb[d]
            z, r, hcand, hh = gru._gates(xp[d, t], hp, u)
            acc = torch.zeros(b, u)
            for rank in range(c):
                acc = acc + parts[rank]
            dh = (zdh + acc) + g[d, t]
            ah = (1 - z) * (1 - hcand * hcand)
            az = (h_prev - hcand) * z * (1 - z)
            ar = ah * hh * r * (1 - r)
            dxp[d, t] = torch.cat([dh * az, dh * ar, dh * ah], -1)
            dhp = torch.cat([dh * az, dh * ar, dh * (ah * r)], -1)
            zdh = dh * z
            for rank in range(c):
                own = torch.zeros(b, 3 * ucw)
                for gate in range(3):
                    n = max(0, min(ucw, u - rank * ucw))
                    own[:, gate * ucw:gate * ucw + n] = \
                        dhp[:, gate * u + rank * ucw:gate * u + rank * ucw + n]
                parts[rank] = own @ w[rank]
    return dxp


@pytest.mark.parametrize("u,c", [(20, 4), (24, 8), (36, 2)])
def test_resident_decomposition_matches_the_plain_version(u, c):
    """The resident recurrence's split of dhp @ Rk^T into per-CTA
    partial sums over each CTA's own dhp (uneven shares: U = 20 on 4 CTAs
    of 8 units, the last none), modelled on the CPU, holds
    `gru_scan_bwd_ref`'s dx_proj in f32."""
    xp, rk, rb, hs, g = map(torch.from_numpy,
                            _bwd_inputs(2, t=9, b=5, u=u, seed=7))
    got = _resident_model(xp, rk, rb, hs, g, c)
    want = gru.gru_scan_bwd_ref(xp, rk, rb, hs, g)[0]
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_bwd_plan_at_the_path_shapes():
    """Training (B=256) one CTA a SM in 2-CTA clusters of 256 threads, as
    the forward; the feed's B=64 and small B on the latency variant."""
    train = gru._bwd_plan(2, 256, 128)
    assert (train.variant, train.bt, train.c, train.threads, train.ctas) \
        == (gru._BWD_BATCH, 8, 2, 256, 128)
    assert train.ctas <= gru._SMS
    feed = gru._bwd_plan(2, 64, 128)
    assert (feed.variant, feed.bt, feed.c) == (gru._BWD_LATENCY, 4, 8)
    for b in (1, 8, 10, 64, 128, 1000):
        p = gru._bwd_plan(2, b, 128)
        assert p.variant == gru._BWD_BATCH or \
            p.ctas * p.threads <= gru._LATENCY_THREADS
    assert gru._bwd_plan(2, 8, 144).variant == gru._BWD_WIDE
    for u in (192, 208, 256):
        assert gru._bwd_plan(2, 256, u).variant == gru._BWD_WIDEST
    with pytest.raises(ValueError, match="does not take"):
        gru._bwd_plan(2, 8, 144, variant=gru._BWD_LATENCY)


@pytest.mark.parametrize("u", [2, 6, 164, 200, 262, 386])
def test_bwd_plan_raises_on_a_u_it_cannot_take(u):
    with pytest.raises(ValueError, match="U % 4"):
        gru._bwd_plan(2, 8, u)


def _cuda_table(source, name):
    """A `constexpr` table or constant of a csrc/ file, parsed from its
    text: the tuples of `name`'s braces, or its integer."""
    import os
    import re
    with open(os.path.join(kernels.CSRC_DIR, source)) as f:
        src = f.read()
    m = re.search(name + r"(?:\[\])? = (\{.*?\}\}|\d+);", src, re.S)
    body = m.group(1)
    if body.isdigit():
        return int(body)
    return tuple(tuple(int(x) for x in t.split(","))
                 for t in re.findall(r"\{([\d,\s]+)\}", body))


def test_variant_tables_equal_their_cuda_sources():
    """ops/gru.py's plan tables are the kernels' own (chip_smoke holds
    them against the built libraries too)."""
    assert _cuda_table("gru_bwd.cu", "kVariants") == gru._BWD_VARIANTS
    assert _cuda_table("gru_bwd.cu", "kMaxWeights") == gru._BWD_MAX_WEIGHTS
    assert _cuda_table("gru_fwd.cu", "kVariants") == gru._FWD_VARIANTS
    for source in ("gru_fwd.cu", "gru_bwd.cu"):
        assert tuple(_cuda_table(source, name) for name in (
            "kStreamBT", "kStreamThreads", "kStreamChunk",
            "kStreamSplits")) == gru._STREAM
        assert _cuda_table(source, "kRegisterUnits") == gru._MAX_UNITS
        assert _cuda_table(source, "kResidentUnits") == gru._RESIDENT_UNITS
    assert _cuda_table("gru_fwd.cu", "kResident") == gru._FWD_RESIDENT
    assert _cuda_table("gru_bwd.cu", "kResident") == gru._BWD_RESIDENT
    assert _cuda_table("gru_bwd.cu", "kGroupUnits") == gru._GROUP_UNITS
    # the grid-resident plans (a producer warp beside the consumers)
    assert (_cuda_table("gru_fwd.cu", "kGridUnits"),
            _cuda_table("gru_fwd.cu", "kGridConsumers") + 32,
            _cuda_table("gru_fwd.cu", "kGridRows"),
            _cuda_table("gru_fwd.cu", "kGridParts")) == gru._GRID_FWD
    assert tuple(_cuda_table("gru_bwd.cu", name) for name in (
        "kGridSplit", "kGridUnits", "kGridConsumers", "kGridParts",
        "kGridTiles", "kGridRows")) == \
        gru._GRID_BWD[:2] + (gru._GRID_BWD[2] - 32,) + gru._GRID_BWD[3:]


def _bwd_model(xp, rk, rb, hs, g):
    """Plain-torch model of csrc/gru_bwd.cu's decomposition: hp for every
    step in one product (pass 1); the gate coefficients that make dx_proj
    and dhp linear in dh; one product a step, dh_prev = dh z + dhp @ Rk^T
    (pass 2); dRk and dRb as sums over all rows (pass 3). Tests only."""
    d_dirs, t_steps, b, k = xp.shape
    u = k // 3
    dxp = torch.empty_like(xp)
    drk = torch.empty_like(rk)
    drb = torch.empty_like(rb)
    for d in range(d_dirs):
        order = list(gru._step_order(d, t_steps))
        prev = torch.zeros_like(hs[d])
        for p in range(1, t_steps):
            prev[order[p]] = hs[d, order[p - 1]]
        hp = prev @ rk[d] + rb[d]                            # [T, B, 3U]
        z = torch.sigmoid(xp[d, ..., :u] + hp[..., :u])
        r = torch.sigmoid(xp[d, ..., u:2 * u] + hp[..., u:2 * u])
        hh = hp[..., 2 * u:]
        c = torch.tanh(xp[d, ..., 2 * u:] + r * hh)
        ah = (1 - z) * (1 - c * c)
        az = (prev - c) * z * (1 - z)
        ar = ah * hh * r * (1 - r)
        dhp = torch.empty_like(hp)
        carry = torch.zeros_like(hs[d, 0])
        for p in range(t_steps - 1, -1, -1):
            t = order[p]
            dh = carry + g[d, t]
            dxp[d, t] = torch.cat([dh * az[t], dh * ar[t], dh * ah[t]], -1)
            dhp[t] = torch.cat([dh * az[t], dh * ar[t], dh * ah[t] * r[t]],
                               -1)
            carry = dh * z[t] + dhp[t] @ rk[d].T
        drk[d] = prev.reshape(-1, u).T @ dhp.reshape(-1, k)
        drb[d] = dhp.reshape(-1, k).sum(0)
    return dxp, drk, drb


@pytest.mark.parametrize("d,t,b,u", [(1, 12, 8, 16), (2, 60, 3, 16),
                                     (2, 9, 17, 64)])
def test_kernel_decomposition_matches_the_plain_version(d, t, b, u):
    """The backward's algorithm (hp off the chain, coefficients linear in
    dh, one product a step), modelled on the CPU, holds
    `gru_scan_bwd_ref` in f32."""
    xp, rk, rb, hs, g = map(torch.from_numpy,
                            _bwd_inputs(d, t=t, b=b, u=u, seed=6))
    got = _bwd_model(xp, rk, rb, hs, g)
    want = gru.gru_scan_bwd_ref(xp, rk, rb, hs, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b", [3, 64, 256])
def test_every_bwd_variant_covers_every_state_where_it_takes_u(b):
    """chip_smoke times every variant at the path shapes: each forced plan
    covers every state once too, and a variant that cannot take U raises."""
    for v in range(len(gru._BWD_VARIANTS)):
        for u in (16, 100, 128, 144, 256):
            if not gru._bwd_clusters(v, u):
                with pytest.raises(ValueError, match="does not take"):
                    gru._bwd_plan(2, b, u, variant=v)
                continue
            plan = gru._bwd_plan(2, b, u, variant=v)
            states = _bwd_states(plan, 2, b, u)
            assert len(states) == len(set(states)) == 2 * b * u


@pytest.mark.parametrize("u", [192, 256, 384])
def test_gru_scan_bwd_ref_matches_pallas_interpret_at_wide_units(u):
    xp, rk, rb, hs, g = _bwd_inputs(2, t=5, u=u, seed=9)
    with pltpu.force_tpu_interpret_mode():
        want = jax_gru._gru_scan_bwd_impl(*map(jnp.asarray,
                                               (xp, rk, rb, hs, g)))
    got = gru.gru_scan_bwd_ref(*map(torch.from_numpy, (xp, rk, rb, hs, g)))
    _close(got, want)


@pytest.mark.parametrize("u", [6, 192, 256])
def test_gru_layer_grads_match_jax_scan_grad_at_any_units(u):
    """U = 6 runs the plain recurrence under torch's autograd, 192 and 256
    the Function's hand-written backward (its plain version here); both
    against jax.grad of the JAX layer's lax.scan path."""
    rng = np.random.RandomState(10)
    x = rng.randn(8, 5, 12).astype(np.float32)
    w = rng.randn(8, 5, u).astype(np.float32)
    scan = JaxGRU(u, bidirectional=True, merge_mode="mul", use_pallas=False)
    v = jax.tree_util.tree_map(np.asarray, scan.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))
    v["params"]["bias"] = (0.1 * rng.randn(*v["params"]["bias"].shape)
                           ).astype(np.float32)
    want_p, want_x = jax.grad(
        lambda p, xx: jnp.sum(scan.apply({"params": p}, xx) * w),
        argnums=(0, 1))(v["params"], x)
    layer = GRU(12, u, bidirectional=True, merge_mode="mul")
    layer.load_state_dict(from_flax(v, layer))
    xt = torch.from_numpy(x).requires_grad_()
    (layer(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               rtol=RTOL, atol=ATOL)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_p[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
