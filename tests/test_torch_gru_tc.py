"""The GRU kernels' tensor-core arithmetic (csrc/gru_bwd.cu's hp and dRk
passes, csrc/gru_fwd.cu's and gru_bwd.cu's grid-resident recurrences),
emulated in plain PyTorch on the CPU and held against the plain versions
(`gru_scan_ref`, `gru_scan_bwd_ref`) and the JAX package's Pallas kernels
in interpret mode, at the chip check's tolerances, which do not move for
the tensor cores:
  GRU_TOL: |hs - ref| <= 1e-4 in f32, 2^-7 in bf16 storage;
  BWD_TOL: max |got - ref| / max |ref| <= 1e-5 (dx_proj in f32, dRk and
  dRb always), 2^-7 (dx_proj in bf16 storage).

The emulation does what the kernels do: each f32 operand is split into
bf16 parts (rounded to nearest even by bit masking, each part from what the
earlier ones leave), each 32-deep chunk of K is the f32 sum of the part
products (a, b) with a + b < 3, smallest first, and the chunks are added
in order. A bf16 operand (hs in bf16 storage, Rk handed over in bf16) is
one part; a bf16 array whose rows TMA cannot load (U % 8 == 4) reaches
the passes as an f32 copy (`_tma_rows`), three parts of which two are
zero. Also the plans: that the grid-resident plans cover every state once
within the card's SMs and shared memory, and which plan each shape takes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from seld_tpu.ops.pallas import gru as jax_gru
from seld_tpu_torch.ops import gru

torch.set_num_threads(1)
GRU_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
CHUNK = 32        # K values a chunk (tc::kK)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to the nearest bf16, ties to even, by masking its
    bits; returned as f32."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def bf16_parts(x: torch.Tensor, n: int) -> list:
    """x = parts[0] + parts[1] + ..., each a bf16 value."""
    parts, rest = [], x.float()
    for _ in range(n):
        p = round_bf16(rest)
        parts.append(p)
        rest = rest - p
    return parts


def n_parts(dtype: torch.dtype) -> int:
    return 1 if dtype == torch.bfloat16 else 3


def split_product(a: torch.Tensor, b: torch.Tensor, pa: int, pb: int,
                  chunk: int = CHUNK) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the tensor-core passes form it: the pairs of
    bf16 parts with a + b < max(pa, pb), smallest first, a chunk of K at a
    time, each chunk's f32 partial sum added to the total in f32."""
    sa, sb = bf16_parts(a, pa), bf16_parts(b, pb)
    top = max(pa, pb)
    total = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], chunk):
        part = torch.zeros_like(total)
        for s in range(top - 1, -1, -1):
            for i in range(s + 1):
                j = s - i
                if i < pa and j < pb:
                    part = part + sa[i][:, k0:k0 + chunk] @ \
                        sb[j][k0:k0 + chunk]
        total = total + part
    return total


def _h_prev(hs_d: torch.Tensor, d: int) -> torch.Tensor:
    """h_prev of each real step of direction d: hs at the previous scan
    step, zero at the scan start (gru_bwd.cu's prev_row)."""
    order = list(gru._step_order(d, hs_d.shape[0]))
    prev = torch.zeros_like(hs_d)
    for p in range(1, len(order)):
        prev[order[p]] = hs_d[order[p - 1]]
    return prev


def tc_bwd(xp, rk, rb, hs, g, dhp_parts=None):
    """gru_scan_bwd as the kernels compute it with the tensor-core passes:
    hp and dRk by `split_product`; the recurrence's dhp @ Rk^T in f32, or,
    with dhp_parts, as the grid-resident recurrence forms it (dhp split
    into that many bf16 parts against bf16 Rk, f32 partial sums)."""
    d_dirs, t_steps, b, k = xp.shape
    u = k // 3
    pa, pb = n_parts(hs.dtype), n_parts(rk.dtype)
    rkf, rbf = rk.float(), rb.float()
    dxp = torch.empty(xp.shape)
    drk = torch.empty(rk.shape)
    drb = torch.empty(rb.shape)
    for d in range(d_dirs):
        order = list(gru._step_order(d, t_steps))
        prev = _h_prev(hs[d].float(), d).reshape(-1, u)
        hp = (split_product(prev, rkf[d], pa, pb) + rbf[d]).reshape(
            t_steps, b, k)
        dhp = torch.empty(t_steps, b, k)
        dh = torch.zeros(b, u)
        for p in range(t_steps - 1, -1, -1):
            t = order[p]
            h_prev = prev.reshape(t_steps, b, u)[t]
            z, r, c, hh = gru._gates(xp[d, t].float(), hp[t], u)
            dh = dh + g[d, t].float()
            da_h = dh * (1 - z) * (1 - c * c)
            da_z = dh * (h_prev - c) * z * (1 - z)
            da_r = da_h * hh * r * (1 - r)
            dxp[d, t] = torch.cat([da_z, da_r, da_h], -1)
            dhp[t] = torch.cat([da_z, da_r, da_h * r], -1)
            if dhp_parts is None:
                back = dhp[t] @ rkf[d].T
            else:
                back = split_product(dhp[t], rkf[d].T, dhp_parts, 1)
            dh = dh * z + back
        drk[d] = split_product(prev.T.contiguous(), dhp.reshape(-1, k),
                               pa, 3)
        drb[d] = dhp.reshape(-1, k).sum(0)
    return dxp.to(xp.dtype), drk, drb


def tc_fwd(xp, rk, rb, h_parts):
    """gru_scan as the grid-resident forward forms it: each step's
    h_{t-1} @ Rk with h split into `h_parts` bf16 parts (Rk in bf16, one
    part), chunk by chunk; the gates and the state in f32."""
    d_dirs, t_steps, b, k = xp.shape
    u = k // 3
    hs = torch.empty(d_dirs, t_steps, b, u)
    for d in range(d_dirs):
        h = torch.zeros(b, u)
        for t in gru._step_order(d, t_steps):
            hp = split_product(h, rk[d].float(), h_parts, 1) + rb[d].float()
            z, _, c, _ = gru._gates(xp[d, t].float(), hp, u)
            h = z * h + (1 - z) * c
            hs[d, t] = h
    return hs.to(xp.dtype)


def _inputs(d, t, b, u, seed, dtype=torch.float32, rk_dtype=torch.float32):
    rng = np.random.RandomState(seed)
    xp = rng.randn(d, t, b, 3 * u).astype(np.float32)
    rk = (rng.randn(d, u, 3 * u) / np.sqrt(u)).astype(np.float32)
    rb = (0.1 * rng.randn(d, 3 * u)).astype(np.float32)
    g = rng.randn(d, t, b, u).astype(np.float32)
    xp_t = torch.from_numpy(xp).to(dtype)
    rk_t = torch.from_numpy(rk).to(rk_dtype)
    rb_t = torch.from_numpy(rb)
    hs = gru.gru_scan_ref(xp_t, rk_t, rb_t)
    return xp_t, rk_t, rb_t, hs, torch.from_numpy(g).to(dtype)


def _rel(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _assert_bwd_close(got, want, dtype):
    tols = (BWD_TOL[dtype], BWD_TOL[torch.float32], BWD_TOL[torch.float32])
    for name, a, w, tol in zip(("dx_proj", "dRk", "dRb"), got, want, tols):
        assert _rel(a, w) <= tol, (name, _rel(a, w), tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bit_mask_rounding_is_torch_bf16_cast(seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(np.concatenate([
        rng.randn(4096), 1e-3 * rng.randn(1024), 1e4 * rng.randn(1024),
        # ties: a bf16 value plus half an ulp of it
        (np.float32(1.0) + np.float32(2.0 ** -8)) * np.ones(4)])
        .astype(np.float32))
    torch.testing.assert_close(round_bf16(x), x.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,bound", [(1, 2.0 ** -8), (2, 2.0 ** -16),
                                     (3, 0.0)])
def test_bf16_parts_leave_at_most_their_bound(n, bound):
    """One part is bf16's rounding (2^-8 relative: 8 significant bits), two
    2^-16, three hold an f32 exactly."""
    x = torch.from_numpy(np.random.RandomState(3).randn(8192)
                         .astype(np.float32))
    rest = (x - sum(bf16_parts(x, n))).abs()
    assert (rest <= bound * x.abs()).all()
    for p in bf16_parts(x, n):
        assert torch.equal(p, p.to(torch.bfloat16).float())


@pytest.mark.parametrize("pa,pb", [(1, 1), (1, 3), (3, 1), (3, 3)])
def test_split_product_is_an_f32_product(pa, pb):
    """Against float64: a split product is as close as torch's own f32
    product (a bf16 side is one exact part)."""
    rng = np.random.RandomState(4)
    a = torch.from_numpy(rng.randn(64, 1024).astype(np.float32))
    b = torch.from_numpy(rng.randn(1024, 96).astype(np.float32))
    if pa == 1:
        a = round_bf16(a)
    if pb == 1:
        b = round_bf16(b)
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    got = (split_product(a, b, pa, pb).double() - exact).abs().max().item()
    f32 = ((a @ b).double() - exact).abs().max().item()
    assert got <= max(4 * f32, 1e-6 * scale), (got, f32, scale)


@pytest.mark.parametrize("d,t,b,u,dtype,rk_dtype", [
    (1, 12, 8, 16, torch.float32, torch.float32),
    (2, 12, 8, 32, torch.float32, torch.float32),
    (2, 12, 8, 32, torch.bfloat16, torch.float32),
    (2, 9, 32, 64, torch.bfloat16, torch.bfloat16),
    (2, 12, 17, 40, torch.float32, torch.bfloat16),
])
def test_tc_passes_hold_the_plain_backward(d, t, b, u, dtype, rk_dtype):
    """hp and dRk as the tensor-core passes form them keep gru_scan_bwd_ref
    within BWD_TOL, f32 and bf16 storage, Rk in f32 or bf16."""
    xp, rk, rb, hs, g = _inputs(d, t, b, u, 5, dtype, rk_dtype)
    # Rk's own values in f32, so that the reference's dRk stays f32
    _assert_bwd_close(tc_bwd(xp, rk, rb, hs, g),
                      gru.gru_scan_bwd_ref(xp, rk.float(), rb, hs, g), dtype)


@pytest.mark.parametrize("d", [1, 2])
def test_tc_passes_hold_the_pallas_kernel_in_interpret_mode(d):
    """The same against the JAX package's _gru_scan_bwd_impl (the Pallas
    BPTT kernel, interpret mode), in f32."""
    xp, rk, rb, hs, g = _inputs(d, 12, 8, 32, 6)
    with pltpu.force_tpu_interpret_mode():
        want = jax_gru._gru_scan_bwd_impl(*(jnp.asarray(a.numpy()) for a in
                                            (xp, rk, rb, hs, g)))
    got = tc_bwd(xp, rk, rb, hs, g)
    _assert_bwd_close(got, [torch.from_numpy(np.array(w)) for w in want],
                      torch.float32)


def test_tc_passes_hold_the_plain_backward_at_u1024():
    """One U = 1024 slice (B = 2, T = 3): a K of 1024 for hp, 32 chunks
    added in f32."""
    xp, rk, rb, hs, g = _inputs(2, 3, 2, 1024, 7)
    _assert_bwd_close(tc_bwd(xp, rk, rb, hs, g),
                      gru.gru_scan_bwd_ref(xp, rk, rb, hs, g), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_forward_split_holds_the_plain_forward(dtype):
    """The grid-resident forward's h @ Rk with h in `_GRID_H_PARTS` bf16
    parts and Rk in bf16 keeps gru_scan_ref within GRU_TOL."""
    xp, rk, rb, _, _ = _inputs(2, 12, 8, 64, 8, dtype, torch.bfloat16)
    got = tc_fwd(xp, rk, rb, gru._GRID_H_PARTS)
    want = gru.gru_scan_ref(xp, rk, rb)
    assert (got.float() - want.float()).abs().max().item() <= GRU_TOL[dtype]


def test_grid_forward_split_holds_the_pallas_kernel_at_u1024():
    """At U = 1024 (B = 8, T = 3) against the Pallas forward in interpret
    mode, f32 storage with Rk in bf16."""
    xp, rk, rb, _, _ = _inputs(1, 3, 8, 1024, 9, torch.float32,
                               torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = jax_gru.gru_scan(jnp.asarray(xp.numpy()),
                                jnp.asarray(rk.float().numpy()),
                                jnp.asarray(rb.numpy()))
    got = tc_fwd(xp, rk, rb, gru._GRID_H_PARTS)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= \
        GRU_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_backward_split_holds_the_plain_backward(dtype):
    """The grid-resident backward's dhp @ Rk^T with dhp in
    `_GRID_DHP_PARTS` bf16 parts against bf16 Rk keeps gru_scan_bwd_ref
    within BWD_TOL (with the tensor-core passes around it)."""
    xp, rk, rb, hs, g = _inputs(2, 12, 8, 64, 10, dtype, torch.bfloat16)
    _assert_bwd_close(tc_bwd(xp, rk, rb, hs, g, gru._GRID_DHP_PARTS),
                      gru.gru_scan_bwd_ref(xp, rk.float(), rb, hs, g), dtype)


@pytest.mark.parametrize("shape,dtype,copied", [
    ((2, 6, 8, 128), torch.bfloat16, False),    # hs, 256 bytes a row
    ((2, 128, 384), torch.bfloat16, False),     # Rk
    ((2, 6, 8, 128), torch.float32, False),
    ((2, 3, 17, 260), torch.float32, False),
    ((2, 3, 17, 100), torch.float32, False),
    ((2, 3, 17, 100), torch.bfloat16, True),    # hs, 200 bytes a row
    ((2, 260, 780), torch.bfloat16, True),      # Rk, 1560 bytes a row
    ((1, 4, 3072), torch.bfloat16, False),      # Rk at U = 1024
])
def test_tma_rows_copies_only_rows_tma_cannot_load(shape, dtype, copied):
    """The passes read an array as it comes where its rows are a multiple
    of 16 bytes, else an f32 copy of it (bf16 with U % 8 == 4)."""
    a = torch.from_numpy(np.random.RandomState(12).randn(*shape)
                         .astype(np.float32)).to(dtype)
    got = gru._tma_rows(a)
    if copied:
        assert got.dtype == torch.float32 and torch.equal(got, a.float())
    else:
        assert got is a
    assert got.shape[-1] * got.element_size() % 16 == 0


@pytest.mark.parametrize("u", [20, 100])
def test_f32_copies_of_bf16_arrays_leave_the_passes_bit_equal(u):
    """bf16 hs and Rk with U % 8 == 4 reach the passes as f32 copies: their
    parts are (value, 0, 0), so hp and dRk are the one-part products bit
    for bit, and the backward holds gru_scan_bwd_ref."""
    xp, rk, rb, hs, g = _inputs(2, 6, 8, u, 11, torch.bfloat16,
                                torch.bfloat16)
    prev = _h_prev(hs[1].float(), 1).reshape(-1, u)
    dhp = torch.from_numpy(np.random.RandomState(13).randn(6 * 8, 3 * u)
                           .astype(np.float32))
    assert torch.equal(split_product(prev, rk[1].float(), 3, 3),
                       split_product(prev, rk[1].float(), 1, 1))
    assert torch.equal(split_product(prev.T.contiguous(), dhp, 3, 3),
                       split_product(prev.T.contiguous(), dhp, 1, 3))
    _assert_bwd_close(tc_bwd(xp, rk, rb, hs, g),
                      gru.gru_scan_bwd_ref(xp, rk.float(), rb, hs, g),
                      torch.bfloat16)


def _fwd_grid_states(plan, d, b, u):
    """The (direction, row, unit) states the grid-resident forward's CTAs
    own, CTA x of direction x // (U / 16) the 16 units from 16 (x % (U /
    16)) and every row (csrc/gru_fwd.cu)."""
    units = gru._GRID_FWD[0]
    cpd = u // units
    assert plan.ctas == d * cpd
    return [(x // cpd, row, x % cpd * units + j)
            for x in range(plan.ctas) for j in range(units)
            for row in range(b)]


def _bwd_grid_states(plan, d, b, u):
    """... and the backward's: CTA x is rank x % 4 of group x // 4 (64
    units); thread (j, rs) of rank r owns unit j and rows r Bp / 4 + rs
    kRows + i, kRows = Bp / 16 (csrc/gru_bwd.cu)."""
    split, units = gru._GRID_BWD[:2]
    bp = gru._bwd_grid_bp(b)
    rb, rows = bp // split, bp // split // 4
    groups = u // units
    assert plan.ctas == d * groups * split
    out = []
    for x in range(plan.ctas):
        group, r = divmod(x, split)
        dd, q = divmod(group, groups)
        for j in range(units):
            for rs in range(4):
                for i in range(rows):
                    row = r * rb + rs * rows + i
                    if row < b:
                        out.append((dd, row, q * units + j))
    return out


@pytest.mark.parametrize("d,b,u", [(2, 256, 1024), (2, 8, 1024),
                                   (2, 100, 640), (1, 200, 768),
                                   (2, 3, 768), (1, 128, 1536)])
def test_grid_plans_cover_every_state_once_within_the_card(d, b, u):
    """Each grid-resident plan's CTAs own every (direction, row, unit)
    state once, fit the card's 132 SMs one a SM and a block's 227 KB of
    shared memory."""
    fplan = gru._fwd_plan(d, b, u, rk_bf16=True)
    bplan = gru._bwd_plan(d, b, u, rk_bf16=True)
    assert fplan.variant == gru._FWD_GRID and bplan.variant == gru._BWD_GRID
    for plan, states in ((fplan, _fwd_grid_states(fplan, d, b, u)),
                         (bplan, _bwd_grid_states(bplan, d, b, u))):
        assert len(states) == len(set(states)) == d * b * u
        assert plan.ctas <= gru._SMS
        assert 0 < plan.smem <= gru._SMEM_BLOCK
        assert plan.rk_smem < plan.smem


@pytest.mark.parametrize("d,b,u,rk_dtype,want", [
    (2, 256, 384, torch.bfloat16, ("resident", "resident")),
    (2, 256, 512, torch.bfloat16, ("resident", "resident")),
    (2, 256, 1024, torch.bfloat16, ("grid", "grid")),
    (2, 256, 1024, torch.float32, ("streamed", "streamed")),
    (2, 17, 544, torch.bfloat16, ("grid", "streamed")),
    (2, 3, 2056, torch.bfloat16, ("streamed", "streamed")),
    (2, 300, 1024, torch.bfloat16, ("streamed", "streamed")),
    (2, 256, 1152, torch.bfloat16, ("streamed", "streamed")),  # 144 CTAs
    (1, 256, 1152, torch.bfloat16, ("grid", "grid")),
    # Rk's 96 bytes a unit a CTA beside two ring stages pass 227 KB
    (1, 256, 2048, torch.bfloat16, ("streamed", "streamed")),
])
def test_each_u_and_rk_dtype_routes_to_the_plan_the_rule_says(
        d, b, u, rk_dtype, want):
    """Up to U = 512 the resident plans; past it the grid-resident ones
    where Rk comes in bf16 and they take (D, B, U) (the forward U % 32 ==
    0, the backward U % 128 == 0; B <= 256; D U / 16 <= 132 CTAs), else the
    streamed ones."""
    bf16 = rk_dtype == torch.bfloat16
    kinds = []
    for plan, grid, stream in (
            (gru._fwd_plan(d, b, u, rk_bf16=bf16), gru._FWD_GRID,
             gru._FWD_STREAM),
            (gru._bwd_plan(d, b, u, rk_bf16=bf16), gru._BWD_GRID,
             gru._BWD_STREAM)):
        kinds.append("grid" if plan.variant == grid else
                     "streamed" if plan.variant == stream else "resident")
    assert tuple(kinds) == want


def test_every_u_past_256_keeps_a_plan_for_either_rk_dtype():
    """Every U % 4 == 0 past 256 has a forward and a backward plan, Rk in
    f32 or bf16, at a small and the training batch."""
    for u in range(260, 2100, 4):
        assert gru.gru_kernel_applicable(u)
        for b in (3, 256):
            for bf16 in (False, True):
                gru._fwd_plan(2, b, u, rk_bf16=bf16)
                gru._bwd_plan(2, b, u, rk_bf16=bf16)


def test_grid_variant_is_refused_where_it_does_not_take_u():
    with pytest.raises(ValueError, match="does not take"):
        gru._fwd_plan(2, 256, 1000, variant=gru._FWD_GRID)
    with pytest.raises(ValueError, match="does not take"):
        gru._bwd_plan(2, 256, 544, variant=gru._BWD_GRID)
