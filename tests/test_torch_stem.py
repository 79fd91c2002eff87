"""The port's fused stem (seld_tpu_torch/ops/stem.py, ops/stem_bwd.py)
against the JAX package: `conv_bn_relu_pool` forward and backward (whose
dy pass runs the Pallas `stem_dy` in interpret mode on the CPU), the plain
`stem_dy_ref` against `_dy_xla` and the Pallas `stem_dy` on data with pool
ties, and the train-mode `Conv2DBN` against the JAX `Conv2DBN` on its fused
path (SELD_FUSED_STEM=always, set per test).

Tolerances: 1e-5 for f32 forwards (the conv's sums run in another order);
2e-4 for gradients, which pass through the conv's reductions over
B*T*F terms (as tests/test_stem.py); dy from the same y, dpooled and
params6 is the same f32 formula on both sides, to 1e-6. A CPU model of
csrc/stem_dy.cu's decomposition (`_kernel_model`) holds `stem_dy_ref`: dy
to 1e-6 (one bf16 ulp in bf16), dbias, summed in the kernel's order, to
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.models.layers import Conv2DBN as JaxConv2DBN
from seld_tpu.ops import stem as jax_stem
from seld_tpu.ops.pallas import stem_bwd as jax_stem_bwd
from seld_tpu_torch.bridge import from_flax
from seld_tpu_torch.models.layers import Conv2DBN
from seld_tpu_torch.ops import kernels, stem, stem_bwd

torch.set_num_threads(1)
FWD_TOL, GRAD_TOL, DY_TOL = 1e-5, 2e-4, 1e-6
POOL = (5, 2)


def _data(b=3, t=20, f=8, ci=7, co=16, seed=0):
    """Distinct inputs, so no pool window holds a tie and autodiff's
    first-match routing and the count-normalised routing agree."""
    rng = np.random.RandomState(seed)
    x = rng.permutation(np.arange(b * t * f * ci, dtype=np.float32))
    x = (x.reshape(b, t, f, ci) / x.size - 0.5) * 4
    kernel = rng.randn(7, 7, ci, co).astype(np.float32) * 0.2
    bias = rng.randn(co).astype(np.float32) * 0.1
    gamma = rng.rand(co).astype(np.float32) * 0.8 + 0.6
    beta = rng.randn(co).astype(np.float32) * 0.2
    return x, kernel, bias, gamma, beta


def _tied_dy_inputs(dtype, seed=1, b=2, t=20, f=8, c=16, pool=POOL):
    """y on a coarse grid with many negatives: windows hold exact ties of
    their positive maximum and ReLU zeros."""
    rng = np.random.RandomState(seed)
    y = (rng.randint(-6, 5, (b, t, f, c)) / 4.0).astype(np.float32)
    dp = rng.randn(b, t // pool[0], f // pool[1], c).astype(np.float32)
    p6 = np.stack([0.1 * rng.randn(c), 1 + 0.1 * rng.rand(c),
                   1 + 0.2 * rng.rand(c), 0.1 * rng.randn(c),
                   1e-3 * rng.randn(c), 1e-3 * rng.randn(c)]
                  ).astype(np.float32)
    yt = torch.from_numpy(y).to(dtype)
    return yt, torch.from_numpy(dp), torch.from_numpy(p6)


def test_fused_forward_and_grads_match_jax():
    x, kernel, bias, gamma, beta = _data()
    w = np.random.RandomState(2).randn(3, 4, 4, 16).astype(np.float32)

    def jax_loss(*args):
        pooled, _, _ = jax_stem.conv_bn_relu_pool(*args, POOL, 1e-3)
        return jnp.sum(jnp.sin(pooled) ** 2 * w)

    jargs = [jnp.asarray(a) for a in (x, kernel, bias, gamma, beta)]
    want_fwd = jax_stem.conv_bn_relu_pool(*jargs, POOL, 1e-3)
    want_grads = jax.grad(jax_loss, argnums=range(5))(*jargs)

    targs = [torch.from_numpy(a).requires_grad_()
             for a in (x, kernel, bias, gamma, beta)]
    before = kernels.launch_counts["stem_dy"]
    got_fwd = stem.conv_bn_relu_pool(*targs, POOL, 1e-3)
    (torch.sin(got_fwd[0]) ** 2 * torch.from_numpy(w)).sum().backward()
    assert kernels.launch_counts["stem_dy"] == before
    for g, want in zip(got_fwd, want_fwd):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    names = ("dx", "dkernel", "dbias", "dgamma", "dbeta")
    for name, a, want in zip(names, targs, want_grads):
        assert a.grad.dtype == a.dtype
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("pool", [POOL, (5, 1), (5, 4), (10, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_dy_ref_matches_jax_on_ties(dtype, pool):
    y, dp, p6 = _tied_dy_inputs(getattr(torch, dtype), pool=pool)
    got_dy, got_db = stem_bwd.stem_dy_ref(y, dp, p6, pool)
    yj = jnp.asarray(y.float().numpy()).astype(getattr(jnp, dtype))
    dpj, p6j = jnp.asarray(dp.numpy()), jnp.asarray(p6.numpy())
    want_xla = jax_stem._dy_xla(yj, dpj, p6j, pool)
    want_pallas = jax_stem_bwd.stem_dy(yj, dpj, p6j, pool, interpret=True)
    assert got_dy.dtype == y.dtype and got_db.dtype == torch.float32
    # exactly one bf16 rounding of the same f32 value on both sides
    dy_tol = DY_TOL if dtype == "float32" else 2.0 ** -8
    for want_dy, want_db in (want_xla, want_pallas):
        np.testing.assert_allclose(got_dy.float().numpy(),
                                   np.asarray(want_dy, np.float32),
                                   rtol=dy_tol, atol=DY_TOL)
        np.testing.assert_allclose(got_db.numpy(), np.asarray(want_db),
                                   rtol=1e-5, atol=1e-5)


def test_stem_dy_on_cpu_writes_out_and_routes_ties_by_count():
    y, dp, p6 = _tied_dy_inputs(torch.float32, seed=3)
    want_dy, want_db = stem_bwd.stem_dy_ref(y, dp, p6, POOL)
    out = torch.empty_like(y)
    dy, db = stem_bwd.stem_dy(y, dp, p6, POOL, out=out)
    assert dy is out and torch.equal(dy, want_dy) and torch.equal(db,
                                                                  want_db)
    # with the BN terms zeroed, a window's routed mass is dpooled where its
    # maximum is positive, split over its ties
    p6[4:] = 0
    dy, _ = stem_bwd.stem_dy_ref(y, dp, p6, POOL)
    scale = (p6[1] * p6[2])
    routed = (dy / scale).reshape(2, 4, 5, 4, 2, 16).sum(dim=(2, 4))
    bno = y * (p6[1] * p6[2]) + (p6[3] - p6[2] * p6[0] * p6[1])
    m = bno.reshape(2, 4, 5, 4, 2, 16).amax(dim=(2, 4))
    torch.testing.assert_close(routed, dp * (m > 0), rtol=1e-5, atol=1e-6)


def test_routing_sees_the_forwards_exact_bf16_values():
    """The backward routes a window's gradient to the elements equal to the
    forward's saved maximum. In bf16 that holds only if bno is recomputed
    exactly as the forward computed it (`bn_affine`, then y*scale + shift
    in bf16). This data is chosen so that the textbook formula
    (y - mean) * inv * gamma + beta misses the maximum in some windows:
    with it, their gradient would silently vanish."""
    rng = np.random.RandomState(4)
    b, t, f, c = 2, 20, 8, 16
    x = torch.from_numpy(rng.randn(b, t, f, 3).astype(np.float32)
                         ).to(torch.bfloat16)
    kernel = torch.from_numpy(0.3 * rng.randn(3, 3, 3, c).astype(
        np.float32)).to(torch.bfloat16).requires_grad_()
    bias = torch.zeros(c, dtype=torch.bfloat16, requires_grad=True)
    gamma = torch.from_numpy((0.7 + rng.rand(c)).astype(np.float32))
    beta = torch.from_numpy((0.3 * rng.randn(c)).astype(np.float32))
    pooled, mean, var = stem.conv_bn_relu_pool(x, kernel, bias, gamma, beta,
                                               POOL, 1e-3)
    dp = torch.ones_like(pooled, dtype=torch.float32)
    y = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.movedim(-1, 1), (1, 1, 1, 1)),
        kernel.detach().permute(3, 2, 0, 1)).movedim(1, -1)
    inv = torch.rsqrt(var + 1e-3)
    zeros = torch.zeros(c)
    p6 = torch.stack([mean, inv, gamma, beta, zeros, zeros])
    dy, _ = stem_bwd.stem_dy_ref(y, dp, p6, POOL)
    routed = (dy.float() / (inv * gamma)).reshape(
        b, t // 5, 5, f // 2, 2, c).sum(dim=(2, 4))
    torch.testing.assert_close(routed, (pooled > 0).float(), rtol=2e-2,
                               atol=0)

    other = ((y.float() - mean) * inv * gamma + beta).to(torch.bfloat16)
    m_other = other.float().reshape(b, t // 5, 5, f // 2, 2, c).amax(
        dim=(2, 4))
    assert (m_other != pooled.float()).logical_and(pooled > 0).any(), \
        "the data must separate the two formulas"


def test_second_backward_through_the_stem_raises():
    """dy is written over y (y is dead after the pass): the graph's saved y
    is spent, and a second backward says so instead of reading dy."""
    targs = [torch.from_numpy(a).requires_grad_() for a in _data(seed=5)]
    pooled, _, _ = stem.conv_bn_relu_pool(*targs, POOL, 1e-3)
    pooled.sum().backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        pooled.sum().backward()


@pytest.mark.parametrize("case,exc,match", [
    ("rank", ValueError, r"\[B, T, F, C\]"),
    ("pool", ValueError, "must divide"),
    ("channels", ValueError, "at most 256 channels"),
    ("dpooled", ValueError, "dpooled .* does not match"),
    ("params6", ValueError, "params6 must be"),
    ("ydtype", TypeError, "y dtype"),
    ("out", ValueError, "out must have"),
])
def test_stem_dy_cuda_wrapper_checks_raise(case, exc, match):
    y, dp, p6 = _tied_dy_inputs(torch.float32)
    pool, out = POOL, torch.empty_like(y)
    if case == "rank":
        y = y[0]
    elif case == "pool":
        pool = (3, 2)
    elif case == "channels":
        y, dp, p6 = _tied_dy_inputs(torch.float32, c=264)
        out = torch.empty_like(y)
    elif case == "dpooled":
        dp = dp[:, :2]
    elif case == "params6":
        p6 = p6.double()
    elif case == "ydtype":
        y, out = y.half(), out.half()
    elif case == "out":
        out = torch.empty(2, 8, 20, 16).transpose(1, 2)
    with pytest.raises(exc, match=match):
        stem_bwd._check_cuda_args(y, dp, p6, pool, out)


def test_fused_stem_applicable_rules():
    ok = dict(x_shape=(2, 300, 64, 7), pool=(5, 2), strides=(1, 1),
              padding="SAME", groups=1, activation="relu")
    assert stem.fused_stem_applicable(**ok)
    for key, value in (("pool", None), ("activation", "swish"),
                       ("groups", 2), ("padding", "VALID"),
                       ("strides", (2, 1)), ("x_shape", (2, 301, 64, 7))):
        assert not stem.fused_stem_applicable(**{**ok, key: value}), key


@pytest.mark.parametrize("pool", [POOL, (5, 4)])
def test_conv2dbn_train_matches_jax_fused(monkeypatch, pool):
    """Train-mode Conv2DBN with a pool: output, running statistics and the
    gradients of every parameter and of the input, against the JAX layer
    on its fused path. A [5, 4] window takes the kernel's generic path on
    the card."""
    monkeypatch.setenv("SELD_FUSED_STEM", "always")
    rng = np.random.RandomState(6)
    x = (rng.permutation(np.arange(2 * 20 * 8 * 7, dtype=np.float32))
         .reshape(2, 20, 8, 7) / 1000.0)
    w = rng.randn(2, 20 // pool[0], 8 // pool[1], 12).astype(np.float32)
    jm = JaxConv2DBN(12, 5, activation="relu", pool=pool)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(1)}, jnp.asarray(x), train=False))
    v["params"]["Conv_0"]["bias"] = (0.1 * rng.randn(12)).astype(np.float32)

    def loss(params, xx):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(jnp.tanh(out) ** 2 * w), (out, mut["batch_stats"])

    (gp, gx), (want_out, want_stats) = jax.grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    tm = Conv2DBN((20, 8, 7), 12, 5, pool=pool)
    tm.load_state_dict(from_flax(v, tm))
    tm.train()
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    (torch.tanh(out) ** 2 * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=FWD_TOL, atol=FWD_TOL)
    stats = dict(tm.named_buffers())
    for key in ("mean", "var"):
        np.testing.assert_allclose(
            stats[f"BatchNorm_0.{key}"].numpy(),
            np.asarray(want_stats["BatchNorm_0"][key]), rtol=FWD_TOL,
            atol=1e-6, err_msg=key)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    for name, p in tm.named_parameters():
        mod, leaf = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(gp[mod][leaf]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def _cuda_constant(name):
    """A `constexpr` integer or table of (pt, pf) pairs in csrc/stem_dy.cu,
    parsed from its text."""
    import os
    import re
    with open(os.path.join(kernels.CSRC_DIR, "stem_dy.cu")) as f:
        src = f.read()
    body = re.search(name + r"(?:\[\])? = (\{.*?\}\}|\d+);", src, re.S)
    body = body.group(1)
    if body.isdigit():
        return int(body)
    return tuple(tuple(int(x) for x in t.split(","))
                 for t in re.findall(r"\{([\d,\s]+)\}", body))


def test_vector_windows_and_grid_constants_equal_the_cuda_source():
    """The wrapper's copies of the kernel's compile-time windows and grid
    constants (chip_smoke holds the windows against the built library)."""
    assert _cuda_constant("kVecWindows") == stem_bwd._VEC_WINDOWS
    assert _cuda_constant("kThreads") == stem_bwd._THREADS
    assert _cuda_constant("kMaxBlocks") == stem_bwd._MAX_BLOCKS
    assert stem_bwd._ROWS == stem_bwd._THREADS // 32
    assert stem_bwd._MAX_CHANNELS == 32 * 8


def _affine(y, p6):
    scale, shift = stem_bwd.bn_affine(p6[0], p6[1], p6[2], p6[3], y.dtype)
    return scale, shift


def _window_dy(yw, dpw, p6c, scale, shift):
    """dy of one window, [E, K] (E window elements in the kernel's order, K
    channels), and the kernel's online max and count: the max so far, and
    how many elements equal it."""
    mean, inv, gamma, _, dgn, dbn = p6c
    bno = (yw * scale + shift).float()          # the forward's rounding
    m, cnt = bno[0].clone(), torch.ones_like(bno[0])
    for e in range(1, bno.shape[0]):
        v = bno[e]
        cnt = torch.where(v > m, torch.ones_like(cnt),
                          cnt + (v == m).float())
        m = torch.maximum(m, v)
    share = dpw.float() / cnt
    m = torch.where(m > 0, m, torch.full_like(m, float("nan")))
    dyr = torch.where(bno == m, share, torch.zeros_like(bno))
    xhat = (yw.float() - mean) * inv
    return (inv * gamma) * (dyr - dbn - xhat * dgn)


def _finalize(partial):
    """stem_dy_finalize_kernel: thread t sums rows t, t + 256, ... in order,
    then the 256 sums halve pairwise."""
    threads = stem_bwd._THREADS
    s = torch.zeros(threads, partial.shape[1])
    for r in range(partial.shape[0]):
        s[r % threads] += partial[r]
    h = threads // 2
    while h:
        s[:h] = s[:h] + s[h:2 * h]
        h //= 2
    return s[0]


def _kernel_model(y, dp, p6, pool):
    """Plain-torch model of csrc/stem_dy.cu's decomposition: the path
    `_vector_path` picks; on the vector path thread tid of the grid takes
    the (window, channel vector) items tid, tid + stride, ... with its
    vector fixed at tid % (C / V), its dbias sums reduced by the warp's
    xor butterfly over lanes of one vector, then the block's warps in
    order; on the generic path thread (channel lane, row) of block bx the
    windows bx 8 + row, + 8 blocks, ..., the rows summed in order; the
    partial rows then go through the finalize tree. Returns (dy, dbias,
    path, how often each element was written). Tests only."""
    b, t, f, c = y.shape
    pt, pf = pool
    tl_n, fl_n = t // pt, f // pf
    vec = stem_bwd._vector_path(y, pool)
    blocks = stem_bwd._blocks(y.shape, pool, vec, y.element_size())
    threads = stem_bwd._THREADS
    scale, shift = _affine(y, p6)
    dy = torch.zeros(y.shape, dtype=torch.float32)
    writes = torch.zeros(y.shape, dtype=torch.int32)
    partial = torch.zeros(blocks, c)

    def window(bb, tl, fl, chans):
        ts = slice(tl * pt, tl * pt + pt)
        fs = slice(fl * pf, fl * pf + pf)
        yw = y[bb, ts, fs][..., chans].reshape(pt * pf, -1)
        d = _window_dy(yw, dp[bb, tl, fl, chans], p6[:, chans],
                       scale[chans], shift[chans])
        dy[bb, ts, fs, chans] = d.reshape(pt, pf, -1)
        writes[bb, ts, fs, chans] += 1
        return d

    if vec:
        v = 16 // y.element_size()
        nv = c // v
        n_items = b * tl_n * fl_n * nv
        stride = blocks * threads
        sums = torch.zeros(stride, v)
        for tid in range(stride):
            cv = tid % nv
            chans = slice(cv * v, cv * v + v)
            for item in range(tid, n_items, stride):
                w = item // nv
                fl, r = w % fl_n, w // fl_n
                for row in window(r // tl_n, r % tl_n, fl, chans):
                    sums[tid] += row
        for blk in range(blocks):
            for w0 in range(blk * threads, (blk + 1) * threads, 32):
                warp = sums[w0:w0 + 32]
                m = nv
                while m < 32:
                    warp = warp + warp[torch.arange(32) ^ m]
                    m *= 2
                for lane in range(nv):
                    partial[blk, lane * v:lane * v + v] += warp[lane]
    else:
        n_win = b * tl_n * fl_n
        rows = stem_bwd._ROWS
        for blk in range(blocks):
            row_sums = torch.zeros(rows, c)
            for row in range(rows):
                for w in range(blk * rows + row, n_win, blocks * rows):
                    fl, r = w % fl_n, w // fl_n
                    for ch in range(c):
                        d = window(r // tl_n, r % tl_n, fl, slice(ch, ch + 1))
                        for e in range(d.shape[0]):
                            row_sums[row, ch] += d[e, 0]
            for row in range(rows):
                partial[blk] += row_sums[row]
    return dy.to(y.dtype), _finalize(partial), vec, writes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool,layout,vec", [
    ((5, 2), "channels-last", True), ((5, 1), "channels-last", True),
    ((5, 4), "channels-last", False), ((10, 2), "channels-last", False),
    ((5, 2), "channels-first", False)])
def test_kernel_decomposition_matches_the_plain_version(dtype, pool, layout,
                                                        vec):
    """The kernel's algorithm (its thread -> item map, the compile-time
    windows of the vector path, the generic two-pass path, the online max
    and count, the fixed dbias order), modelled on the CPU, holds
    `stem_dy_ref` on data with ties, and writes every element once."""
    dt = getattr(torch, dtype)
    y, dp, p6 = _tied_dy_inputs(dt, seed=7, b=2, t=20, f=8, c=16, pool=pool)
    if layout == "channels-first":
        y = y.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    # the training step hands dpooled over channels-first
    dp = dp.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    got_dy, got_db, got_vec, writes = _kernel_model(y, dp, p6, pool)
    want_dy, want_db = stem_bwd.stem_dy_ref(y, dp, p6, pool)
    assert got_vec == vec and bool((writes == 1).all())
    dy_tol = DY_TOL if dtype == "float32" else 2.0 ** -8
    torch.testing.assert_close(got_dy.float(), want_dy.float(), rtol=dy_tol,
                               atol=DY_TOL)
    torch.testing.assert_close(got_db, want_db, rtol=1e-5, atol=1e-5)


def test_vector_path_rules():
    """Where the kernel's vector path applies: a compile-time window, C
    innermost and unit-stride in y, whole 16-byte vectors of channels a
    power of two of them a pixel, aligned."""
    y, dp, _ = _tied_dy_inputs(torch.bfloat16, c=16)
    assert stem_bwd._vector_path(y, POOL) is True
    assert stem_bwd._vector_path(y, (5, 1)) is True
    assert stem_bwd._vector_path(y, (5, 4)) is False
    y_cf = y.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert stem_bwd._vector_path(y_cf, POOL) is False
    assert stem_bwd._vector_path(y[..., :8], POOL) is True      # nv 1
    y24, _, _ = _tied_dy_inputs(torch.bfloat16, c=24)
    assert stem_bwd._vector_path(y24.to(torch.bfloat16), POOL) is False
    yf, _, _ = _tied_dy_inputs(torch.float32, c=16)
    assert stem_bwd._vector_path(yf, POOL) is True
    shifted = torch.empty(y.numel() + 1, dtype=y.dtype)[1:].view(y.shape)
    assert stem_bwd._vector_path(shifted, POOL) is False
    # no window limit: a 20-element window passes the wrapper's checks
    y20, dp20, p20 = _tied_dy_inputs(torch.float32, pool=(10, 2))
    stem_bwd._check_cuda_args(y20, dp20, p20, (10, 2), torch.empty_like(y20))
