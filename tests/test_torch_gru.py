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


@pytest.mark.parametrize("err", [0, 700], ids=["ok", "refused"])
def test_kernel_launch_checks_then_counts(monkeypatch, err):
    """kernels.launch, every op module's launch protocol, on the current
    card: the entry point gets the raw stream handle last; a non-zero
    return raises with the C error string and counts nothing; a launch
    that succeeded counts one. The card, its stream and the library are
    stand-ins, so the protocol runs here on the CPU."""
    class Lib:
        @staticmethod
        def seld_cuda_error_string(code):
            return f"the error string of {code}".encode()

    calls = []

    def entry(*args):
        calls.append(args)
        return err

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(kernels, "current_stream", lambda device: 0xAB)
    monkeypatch.setitem(kernels._libs, kernels.KERNELS["gru_scan"], Lib())
    before = kernels.launch_counts["gru_scan"]
    if err:
        with pytest.raises(RuntimeError, match=r"^gru_fwd launch: CUDA "
                           r"error 700 \(the error string of 700\)$"):
            kernels.launch("gru_scan", entry, "gru_fwd launch", 0, 1, 2)
    else:
        kernels.launch("gru_scan", entry, "gru_fwd launch", 0, 1, 2)
    assert calls == [(1, 2, 0xAB)]
    assert kernels.launch_counts["gru_scan"] == before + (err == 0)


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
    """GRU dropout in training is ported: masks change the training
    output, eval ignores them (tests/test_torch_blocks.py holds the masks
    against the JAX layer's)."""
    layer = GRU(4, 8, bidirectional=True, dropout=0.5,
                recurrent_dropout=0.5).train()
    x = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(0))
    assert layer(x).shape == (2, 3, 8)
    drop = layer(x)
    layer.eval()
    assert layer(x).shape == (2, 3, 8)
    assert not torch.equal(drop, layer(x))


def _fwd_writes(plan, d, b, u):
    """The (direction, row, unit) states the forward kernel's threads
    write on `plan`, by csrc/gru_fwd.cu's own index arithmetic: CTA
    (blockIdx.x, d) is rank blockIdx.x % C of tile blockIdx.x // C; thread
    tid is lane tid % S of CTA unit tid // S; lane l finishes rows
    [l R, (l + 1) R), R = BT / S. The streamed variant: `_stream_writes`;
    the resident ones: `_resident_writes`."""
    if plan.variant == gru._FWD_STREAM:
        return _stream_writes(plan, b, u)
    if plan.variant in gru._FWD_RES:
        return _resident_writes(plan, b, u)
    s, ni, bt, maxt = gru._FWD_VARIANTS[plan.variant]
    assert plan.bt == bt and u <= 4 * s * ni and bt % s == 0
    assert plan.threads % 32 == 0 and plan.threads <= maxt
    uc, r = u // plan.c, bt // s
    writes = []
    for dd in range(plan.grid[1]):
        for bx in range(plan.grid[0]):
            rank, b0 = bx % plan.c, (bx // plan.c) * bt
            rows = min(bt, b - b0)
            for tid in range(plan.threads):
                lane, uu = tid % s, tid // s
                for j in range(r):
                    if uu < uc and lane * r + j < rows:
                        writes.append((dd, b0 + lane * r + j,
                                       rank * uc + uu))
    return writes


def _stream_writes(plan, b, u):
    """The states the streamed variant's threads finish (both kernels), by
    csrc/gru_{fwd,bwd}.cu's index arithmetic: CTA (blockIdx.x, d) is rank
    blockIdx.x % C of tile blockIdx.x // C of kStreamBT rows; its threads
    are KS groups of UW (tid = ks UW + l); group 0's thread l finishes CTA
    units base + l, base = 0, UW, ..., below U / C, the other groups only
    hand it partial sums."""
    bt, maxt, kc, most = gru._STREAM
    uc = u // plan.c
    ks, uw = gru._stream_split(uc)
    assert plan.bt == bt and plan.threads == ks * uw <= maxt
    assert uw % 32 == 0 and ks <= most and kc % (4 * ks) == 0
    writes = []
    for dd in range(plan.grid[1]):
        for bx in range(plan.grid[0]):
            rank, b0 = bx % plan.c, (bx // plan.c) * bt
            rows = min(bt, b - b0)
            for base in range(0, uc, uw):
                for tid in range(plan.threads):
                    group, lane = divmod(tid, uw)
                    if group == 0 and base + lane < uc:
                        writes += [(dd, b0 + j, rank * uc + base + lane)
                                   for j in range(rows)]
    return writes


def _resident_writes(plan, b, u):
    """The states a resident variant's lanes finish, by csrc/gru_fwd.cu's
    index arithmetic: CTA (blockIdx.x, d) is rank blockIdx.x % C of tile
    blockIdx.x // C of `plan.bt` rows and owns units [rank ucw, rank ucw +
    ucw) below U, ucw = 4 ceil(U / 4C); thread tid is lane tid % S of CTA
    unit tid // S; a step walks the tile's rows in passes of RP, and lane l
    finishes rows p RP + l RP / S + j of pass p."""
    c, s, nr, ns, most, rp = gru._FWD_RESIDENT[plan.variant - gru._FWD_RES[0]]
    ucw = gru._res_cta_units(u, c)
    assert plan.c == c and plan.threads == ucw * s and plan.threads % 32 == 0
    assert c * ucw <= 4 * s * (nr + ns) and rp % s == 0
    assert plan.bt % 8 == 0 and plan.bt <= most and plan.bt % rp == 0
    r = rp // s
    writes = []
    for dd in range(plan.grid[1]):
        for bx in range(plan.grid[0]):
            rank, b0 = bx % c, (bx // c) * plan.bt
            rows = min(plan.bt, b - b0)
            uc = max(0, min(ucw, u - rank * ucw))
            for p in range(-(-rows // rp)):
                for tid in range(plan.threads):
                    lane, uu = tid % s, tid // s
                    for j in range(r):
                        row = p * rp + lane * r + j
                        if uu < uc and row < rows:
                            writes.append((dd, b0 + row, rank * ucw + uu))
    return writes


@pytest.mark.parametrize("u", [64, 128, 152, 192, 200, 256, 260, 384, 388,
                               512, 2056])
@pytest.mark.parametrize("b", [1, 3, 17, 32, 256])
def test_fwd_plan_covers_every_state_exactly_once(b, u):
    """Every (direction, row, unit) once, on clusters of at most 8 CTAs
    that split U evenly (the resident variants, U in (256, 512]: clusters
    of 8 or 16 CTAs of 4 ceil(U / 4C) units, the last ones fewer)."""
    plan = gru._fwd_plan(2, b, u)
    if plan.variant not in gru._FWD_RES:
        assert u % plan.c == 0 and plan.c in gru._CLUSTERS
    assert plan.grid[0] % plan.c == 0
    writes = _fwd_writes(plan, 2, b, u)
    assert len(writes) == len(set(writes)) == 2 * b * u


def test_fwd_plan_fills_the_card_at_the_path_shapes():
    train = gru._fwd_plan(2, 256, 128)      # training: B=256
    serve = gru._fwd_plan(2, 32, 128)       # serving: a B=32 bucket
    assert train.ctas <= gru._SMS
    assert serve.ctas > 16                  # the one-block-per-4-rows design
    assert (train.variant, train.bt, train.c, train.threads) == \
        (gru._FWD_BATCH, 8, 2, 256)
    assert (serve.variant, serve.bt, serve.c) == (gru._FWD_LATENCY, 4, 8)
    for b in (1, 8, 10, 64, 128, 1000):     # the latency variant only while
        p = gru._fwd_plan(2, b, 128)        # its threads fit
        assert p.variant == gru._FWD_BATCH or \
            p.ctas * p.threads <= gru._LATENCY_THREADS
    assert gru._fwd_plan(2, 8, 132).variant == gru._FWD_WIDE
    for u in (152, 192, 256):
        assert gru._fwd_plan(2, 256, u).variant == gru._FWD_WIDEST


def _thread_registers(threads: int) -> int:
    """Registers a thread may have in a block of `threads` (one block a
    SM): 65,536 shared out in steps of 8, at most 255."""
    return min(255, 65536 // threads // 8 * 8)


@pytest.mark.parametrize("u", [260, 292, 384, 388, 448, 512])
def test_resident_plans_fit_the_card(u):
    """Past U = 256 up to U = 512 both kernels plan a resident variant
    whose dynamic shared memory fits a block (227 KiB) and whose Rk
    registers leave a thread at least 40% of its registers; at B = 256 and
    U = 384 each call's clusters fit the card at once (one wave, by
    `_ACTIVE_CLUSTERS`), at U = 512 in two; the split is the kernels'."""
    for b in (3, 17, 256):
        for plan, res in ((gru._fwd_plan(2, b, u), gru._FWD_RES),
                          (gru._bwd_plan(2, b, u), gru._BWD_RES)):
            assert plan.variant in res
            assert plan.c == (8 if u <= 384 else 16)
            assert 0 < plan.smem <= gru._SMEM_BLOCK
            assert plan.rk_smem < plan.smem
            per_thread = plan.rk_reg // plan.threads // 4
            assert per_thread <= 0.6 * _thread_registers(plan.threads)
            # the whole slice of Rk: U x 3 ucw f32 a CTA
            ucw = gru._res_cta_units(u, plan.c)
            assert plan.rk_reg + plan.rk_smem >= u * 3 * ucw * 4
            waves = -(-plan.ctas // plan.c // gru._ACTIVE_CLUSTERS[plan.c])
            if b == 256:
                assert waves == (1 if u <= 384 else 2)
    assert max(gru._FWD_RES_UNITS) == max(gru._BWD_RES_UNITS) == \
        gru._RESIDENT_UNITS
    for u_wide in (516, 1024, 2056):
        assert gru._fwd_plan(2, 256, u_wide).variant == gru._FWD_STREAM
        assert gru._bwd_plan(2, 256, u_wide).variant == gru._BWD_STREAM
    # the streamed variants stay forcible where the resident ones run
    assert gru._fwd_plan(2, 256, u, variant=gru._FWD_STREAM).variant == \
        gru._FWD_STREAM
    assert gru._bwd_plan(2, 256, u, variant=gru._BWD_STREAM).variant == \
        gru._BWD_STREAM


@pytest.mark.parametrize("u", [4, 12, 20, 100, 124, 132, 144, 152, 248])
def test_fwd_plan_takes_every_u_the_kernel_takes(u):
    for b in (1, 17, 256):
        plan = gru._fwd_plan(2, b, u)
        assert len(set(_fwd_writes(plan, 2, b, u))) == 2 * b * u


@pytest.mark.parametrize("u", [2, 6, 148, 262, 386])
def test_fwd_plan_raises_on_a_u_it_cannot_take(u):
    """Before any library load: the wrapper's checks and the plan run on
    CPU tensors here."""
    with pytest.raises(ValueError, match="U % 4"):
        gru._fwd_plan(2, 8, u)
    xp = torch.zeros(2, 5, 8, 3 * u)
    loaded = dict(kernels._libs)
    with pytest.raises(ValueError, match="U % 4"):
        gru._gru_scan_cuda(xp, torch.zeros(2, u, 3 * u), torch.zeros(2, 3 * u))
    assert kernels._libs == loaded
    with pytest.raises(ValueError, match="does not take"):
        gru._fwd_plan(2, 8, 132, variant=gru._FWD_LATENCY)
    for v, w in ((gru._FWD_STREAM, 256), (gru._FWD_WIDEST, 384)):
        with pytest.raises(ValueError, match="does not take"):
            gru._fwd_plan(2, 8, w, variant=v)


def _has_plan(plan, u):
    try:
        plan(2, 8, u)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("u,takes", [(2, False), (4, True), (6, False),
                                     (128, True), (148, False), (200, False),
                                     (208, True), (256, True), (260, True),
                                     (384, True)])
def test_gru_kernel_applicable_is_what_the_plans_take(u, takes):
    """The route rule holds exactly where both kernels have a plan (U = 200
    has a forward plan only: 100 lane groups of the backward split evenly
    over no cluster within 256 threads; past 256 the streamed variants take
    every U % 4 == 0)."""
    assert gru.gru_kernel_applicable(u) == takes
    assert (_has_plan(gru._fwd_plan, u) and _has_plan(gru._bwd_plan, u)) \
        == takes


def test_every_u_the_rule_takes_has_both_plans():
    """Up to U = 1024: below 257 the register variants' rule, above it
    every U % 4 == 0."""
    for u in range(1, 1025):
        assert gru.gru_kernel_applicable(u) or u % 4 or u <= 256
        if gru.gru_kernel_applicable(u):
            for b in (1, 3, 64, 256):
                gru._fwd_plan(2, b, u)
                gru._bwd_plan(2, b, u)
        else:
            assert not (_has_plan(gru._fwd_plan, u)
                        and _has_plan(gru._bwd_plan, u))


def test_the_rule_takes_every_nas_and_shipped_unit_but_6():
    """seld_tpu/nas/search.py's GRU units, and SS5's 128."""
    nas = [4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256]
    assert [u for u in nas if not gru.gru_kernel_applicable(u)] == [6]


@pytest.mark.parametrize("u,route", [
    (128, "kernel"), (256, "kernel"), (6, "plain"), (148, "plain"),
    (384, "kernel"), (512, "kernel"), (4, "kernel"), (1024, "kernel"),
    (390, "plain")])
def test_gru_route(u, route):
    """The plain route only where the JAX package composes the recurrence
    too (U % 128 != 0: here U % 4 != 0, or a U <= 256 that no register
    variant splits); every U % 128 == 0 takes the kernels, at any B and on
    any device (their plain versions on the CPU). Recurrent-dropout masks
    take the masked route at every U."""
    assert gru.gru_route(u) == route
    assert gru.gru_route(u, masked=True) == "masked"


@pytest.mark.parametrize("u", [192, 256, 384])
def test_gru_scan_ref_matches_pallas_interpret_at_wide_units(u):
    xp, rk, rb = _scan_inputs(2, t=5, u=u, seed=7)
    with pltpu.force_tpu_interpret_mode():
        want = jax_gru.gru_scan(jnp.asarray(xp), jnp.asarray(rk),
                                jnp.asarray(rb))
    got = gru.gru_scan_ref(*map(torch.from_numpy, (xp, rk, rb)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("u", [6, 192, 256])
def test_gru_layer_matches_jax_scan_layer_at_any_units(u):
    """U = 6 takes the plain route (no kernel plan), 192 and 256 the
    kernel route (the plain versions on the CPU); the JAX layer runs
    lax.scan for all three here."""
    rng = np.random.RandomState(8)
    x = rng.randn(8, 5, 10).astype(np.float32)
    scan = JaxGRU(u, bidirectional=True, merge_mode="mul", use_pallas=False)
    v = jax.tree_util.tree_map(np.asarray, scan.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))
    v["params"]["bias"] = (0.1 * rng.randn(*v["params"]["bias"].shape)
                           ).astype(np.float32)
    want = np.asarray(scan.apply(v, jnp.asarray(x)))
    layer = GRU(10, u, bidirectional=True, merge_mode="mul")
    layer.load_state_dict(from_flax(v, layer))
    before = kernels.launch_counts["gru_scan"]
    with torch.inference_mode():
        got = layer(torch.from_numpy(x)).numpy()
    assert kernels.launch_counts["gru_scan"] == before
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
