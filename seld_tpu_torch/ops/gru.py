"""Fused (bi)directional GRU recurrence (seld_tpu/ops/pallas/gru.py).

`gru_scan` runs the Keras reset_after recurrence (z|r|h gate order) for one
or two directions over a precomputed input projection, as a
`torch.autograd.Function`. Its forward launches the hand-written sm_90a
kernel in csrc/gru_fwd.cu on a CUDA tensor and runs `gru_scan_ref`, the
plain PyTorch version of the same arithmetic, on a CPU tensor. It saves only
the residuals (x_proj, rec_kernel, rec_bias, hs) and its backward recomputes
the gates: csrc/gru_bwd.cu on a CUDA tensor, `gru_scan_bwd_ref` on a CPU
tensor. There is no fallback from a kernel to its plain version: a CUDA
tensor the kernel does not take raises. Both kernels run each (direction,
batch tile) as a thread block cluster; `_fwd_plan` and `_bwd_plan` pick the
tile, cluster size and variant; each CTA of a cluster owns an equal share
of U. Up to U = 256 the variants hold Rk in registers; from there to
U = 512 the resident variants hold each CTA's slice of Rk in registers and
shared memory (clusters of 8 CTAs up to U = 384, of 16 past it), and past
U = 512 a streamed variant of each kernel reads Rk from device memory every
step. Past U = 256 every U % 4 == 0 has a plan. `gru_kernel_applicable`
holds where both plans exist
(U % 4 == 0, and up to 256 split evenly: every U of the shipped configs
and of the NAS space but 6, and every U the JAX package's Pallas kernel
takes). `gru_route` sends any other U through the plain recurrence under
torch's autograd; the JAX package composes it there too (`lax.scan`,
U % 128 != 0). Recurrent dropout
(masks on h_{t-1} inside the step) takes the "masked" route,
`gru_scan_masked` under torch's autograd, at any U: the JAX layer leaves
its kernel for `lax.scan` there too.

The input projection `x @ kernel + bias[:, 0]` stays one large
`torch.einsum` (`input_projection`, with the per-gate input-dropout masks
where given), and so does its backward, as the JAX package leaves both to
XLA; only the recurrence is the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from seld_tpu_torch.ops import kernels

_SOURCE = "gru_fwd.cu"
_BWD_SOURCE = "gru_bwd.cu"
# csrc/gru_fwd.cu's kVariants: (S lanes splitting a unit's k-range, NI
# 4-row k chunks per lane, BT batch rows per tile, most threads a block may
# have); variant v takes U <= 4 * S * NI
_FWD_VARIANTS = ((4, 8, 8, 256), (4, 8, 4, 256), (4, 9, 8, 256),
                 (8, 8, 8, 256))
_FWD_BATCH, _FWD_LATENCY, _FWD_WIDE, _FWD_WIDEST, _FWD_STREAM = range(5)
_MAX_UNITS = 256              # the widest register variants of both kernels
# csrc/gru_fwd.cu's kResident: (C CTAs a cluster, S lanes splitting a
# unit's k-range, NR and NS 4-row k chunks a lane holds in registers and in
# shared memory, BT the most rows a tile, RP rows a pass); plan indices 5
# and 6. Variant v takes 256 < U <= 4 S (NR + NS), U % 4 == 0; a CTA owns
# 4 ceil(U / 4C) units.
_FWD_RESIDENT = ((8, 8, 7, 5, 40, 8), (16, 8, 11, 5, 40, 8))
_FWD_RES = (5, 6)
# the widest U of each: an h row's 4 S (NR + NS) values
_FWD_RES_UNITS = tuple(4 * s * (nr + ns) for _, s, nr, ns, _, _ in
                       _FWD_RESIDENT)
_RESIDENT_UNITS = 512         # kResidentUnits of both sources
# cudaOccupancyMaxActiveClusters of one-CTA-a-SM clusters on the H100 SXM
# (python -m seld_tpu_torch.gru_probe; chip_smoke prints each resident
# plan's own): the plans keep a call's clusters within these where B allows
_ACTIVE_CLUSTERS = {8: 15, 16: 7}
_SMEM_BLOCK = 232448          # shared memory a block may have (227 KiB)
# csrc/gru_{fwd,bwd}.cu's streamed variant, past _MAX_UNITS: (kStreamBT
# batch rows per tile, kStreamThreads most threads a block, kStreamChunk
# values staged a chunk, kStreamSplits most thread groups splitting a
# chunk); its plan index follows the register variants
_STREAM = (16, 256, 128, 4)
# the grid-resident plans past _RESIDENT_UNITS, Rk handed over in bf16
# (csrc/gru_fwd.cu's and gru_bwd.cu's kGrid* constants, plan index 7 of
# both): the forward's (kGridUnits units a CTA, kGridThreads, kGridRows the
# most batch rows, kGridParts bf16 parts of h), the backward's (kGridSplit CTAs a cluster splitting K,
# kGridUnits units a cluster, kGridThreads, kGridParts bf16 parts of dhp,
# kGridTiles dRb tiles, kGridRows)
_GRID_FWD = (16, 288, 256, 3)
_GRID_H_PARTS = _GRID_FWD[3]
_GRID_BWD = (4, 64, 288, 3, 16, 256)
_GRID_DHP_PARTS = _GRID_BWD[3]
_FWD_GRID = _BWD_GRID = 7
_SMEM_TILE = 32 * 2           # bytes of one row of a 32-deep bf16 tile
_CLUSTERS = (1, 2, 4, 8)      # portable thread block cluster sizes
_SMS = 132                    # H100 SXM
# the latency variant while its warps average at most 4 per SM
_LATENCY_THREADS = _SMS * 128


def _warps(threads: int) -> int:
    """`threads` rounded up to whole warps."""
    return -(-threads // 32) * 32


def _split_clusters(units: int, s: int, maxt: int) -> list:
    """Cluster sizes that split `units` (or lane groups) of S lanes evenly
    over their CTAs within `maxt` threads a CTA."""
    return [c for c in _CLUSTERS
            if units % c == 0 and _warps(units // c * s) <= maxt]


def _fwd_clusters(v: int, u: int) -> list:
    """The cluster sizes on which forward variant v takes U units."""
    s, ni, _, maxt = _FWD_VARIANTS[v]
    return _split_clusters(u, s, maxt) if u <= 4 * s * ni else []


class FwdPlan(NamedTuple):
    """How csrc/gru_fwd.cu runs one call: a cluster of `c` CTAs of
    `threads` threads per (direction, tile of `bt` batch rows); grid
    (tiles * c, D); each CTA owns U / c units (a resident plan: 4 ceil(U /
    4c)). A resident plan holds `rk_reg` bytes of a CTA's Rk slice in
    registers and `rk_smem` in shared memory, of `smem` dynamic shared
    bytes a CTA."""
    variant: int
    bt: int
    c: int
    threads: int
    grid: Tuple[int, int]
    rk_reg: int = 0
    rk_smem: int = 0
    smem: int = 0

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def _stream_cluster(u: int) -> int:
    """The streamed variant's cluster: the largest of 8, 4 dividing U."""
    return 8 if u % 8 == 0 else 4


def _stream_split(units_per_cta: int) -> Tuple[int, int]:
    """(KS, UW) of the .cu's `stream_split`: UW threads a group, the CTA's
    units in whole warps up to kStreamThreads (more are walked in passes),
    and KS groups, as many as fill kStreamThreads, at most
    kStreamSplits."""
    _, maxt, _, most = _STREAM
    uw = min(maxt, _warps(units_per_cta))
    return min(maxt // uw, most), uw


def _stream_plan(plan_type, variant: int, d: int, b: int, u: int):
    """The streamed variant's plan (both kernels): a cluster of
    `_stream_cluster(u)` CTAs per (direction, tile of kStreamBT rows), of
    KS x UW threads (`_stream_split`)."""
    bt = _STREAM[0]
    c = _stream_cluster(u)
    ks, uw = _stream_split(u // c)
    return plan_type(variant, bt, c, ks * uw, (-(-b // bt) * c, d))


def _takes_streamed(u: int) -> bool:
    return u > _MAX_UNITS and u % 4 == 0


def _res_cta_units(u: int, c: int) -> int:
    """A resident CTA's units (the .cu's `res_cta_units`): a multiple of 4
    that C of them cover U with."""
    return 4 * -(-u // (4 * c))


def _res_bt(b: int, most: int) -> int:
    """Rows a resident tile: as few tiles of at most `most` rows as cover
    B, evened out and rounded up to a multiple of 8 (B = 256, most 40: 7
    tiles of 40)."""
    tiles = -(-b // most)
    return 8 * -(-(-(-b // tiles)) // 8)


def _res_variant(widest, first: int, u: int, variant):
    """The resident variant (plan index `first` + i) that takes U:
    `variant` if it does, else the first whose `widest[i]` is at least U;
    None where none does or U is no resident U."""
    if not _takes_streamed(u):
        return None
    takes = [first + i for i, w in enumerate(widest) if u <= w]
    if variant is not None:
        return variant if variant in takes else None
    return takes[0] if takes else None


def _grid_stages(fixed: int, stage: int) -> int:
    """The ring stages that fit a block's shared memory beside `fixed`
    bytes: 2 to 4, 0 where 2 do not fit (the .cu's grid_stages)."""
    stage += 16                   # its two mbarriers
    if fixed + 2 * stage > _SMEM_BLOCK:
        return 0
    return min(4, (_SMEM_BLOCK - fixed) // stage)


def _fwd_grid_smem(b: int, u: int) -> int:
    """The grid-resident forward's shared memory: the alignment slack, the
    Rk tiles (U / 32 chunks of 48 rows), the ring of state chunks (3
    parts); 0 where two stages do not fit."""
    bp = -(-b // 64) * 64
    fixed = 1024 + u // 32 * 48 * _SMEM_TILE
    stage = _GRID_H_PARTS * bp * _SMEM_TILE
    stages = _grid_stages(fixed, stage)
    return fixed + stages * (stage + 16) if stages else 0


def _bwd_grid_bp(b: int) -> int:
    return 64 if b <= 64 else 128 if b <= 128 else 256


def _bwd_grid_smem(b: int, u: int) -> int:
    """The grid-resident backward's: the slack, its Rk tiles (64 rows, a
    quarter of the 3U / 32 chunks), the ring of dhp chunks (3 parts)."""
    split, units, _, parts, _, _ = _GRID_BWD
    fixed = 1024 + 3 * u // 32 // split * units * _SMEM_TILE
    stage = parts * _bwd_grid_bp(b) * _SMEM_TILE
    stages = _grid_stages(fixed, stage)
    return fixed + stages * (stage + 16) if stages else 0


def _fwd_grid_takes(d: int, b: int, u: int) -> bool:
    """Past U = 512 with U % 32 == 0, B <= 256, one CTA of 16 units a SM
    (D U / 16 <= 132) and its shared memory within a block's."""
    units, _, rows, _ = _GRID_FWD
    return (u > _RESIDENT_UNITS and u % (2 * units) == 0 and 1 <= b <= rows
            and d * u // units <= _SMS and _fwd_grid_smem(b, u) > 0)


def _bwd_grid_takes(d: int, b: int, u: int) -> bool:
    """Past U = 512 with U % 128 == 0 (each of the 4 K ranges whole 32-deep
    chunks), B <= 256, D U / 16 CTAs on 132 SMs, and its shared memory."""
    split, units, _, _, _, rows = _GRID_BWD
    return (u > _RESIDENT_UNITS and u % (2 * units) == 0 and 1 <= b <= rows
            and d * u // (units // split) <= _SMS
            and _bwd_grid_smem(b, u) > 0)


def _fwd_grid_plan(d: int, b: int, u: int) -> "FwdPlan":
    """The grid-resident forward: D U / 16 CTAs of 288 threads (one a SM,
    launched cooperatively, no cluster: `c` 1), each holding the 48 Rk
    columns of its 16 units (`rk_smem` bytes) for all T steps; the whole
    batch a tile."""
    units, threads, _, _ = _GRID_FWD
    return FwdPlan(_FWD_GRID, b, 1, threads, (u // units, d), 0,
                   u * 3 * units * 2, _fwd_grid_smem(b, u))


def _bwd_grid_plan(d: int, b: int, u: int) -> "BwdPlan":
    """The grid-resident backward recurrence: D U / 16 CTAs of 288
    threads (one a SM, launched cooperatively, no cluster: `c` 1), in
    groups of 4 that each hold 64 units' Rk rows over a quarter of the 3U
    columns (`rk_smem` bytes a CTA)."""
    split, units, threads, _, _, _ = _GRID_BWD
    ctas = u // (units // split)
    return BwdPlan(_BWD_GRID, b, 1, threads, (ctas, d), 0,
                   units * 3 * u // split * 2, _bwd_grid_smem(b, u))


@functools.lru_cache(maxsize=None)
def _fwd_plan(d: int, b: int, u: int, variant: int = None,
              rk_bf16: bool = False) -> FwdPlan:
    """The forward kernel's tile plan for D directions, B rows, U units.

    The latency variant (BT = 4) spreads each tile over the largest cluster
    that divides U, while its threads fit `_LATENCY_THREADS`; otherwise the
    batch variant (BT = 8), or the wide one past U = 128, packs each tile
    into the smallest cluster whose blocks fit the variant's thread limit
    (at U = 128, B = 256: 2 CTAs of 256 threads, 128 CTAs in all), and the
    widest past U = 144, the streamed one past U = 256. `variant` forces
    one. Raises on a U no variant takes. Past U = 256 the resident variants
    (`_fwd_res_plan`) up to U = 512; past it the grid-resident one
    (`_fwd_grid_plan`) where Rk comes in bf16 (`rk_bf16`) and it takes
    (D, B, U), else the streamed one."""
    if variant == _FWD_GRID or (variant is None and rk_bf16 and
                                _fwd_grid_takes(d, b, u)):
        if not _fwd_grid_takes(d, b, u):
            raise ValueError(f"variant {variant} does not take U={u}, B={b}")
        return _fwd_grid_plan(d, b, u)
    if _takes_streamed(u):
        if variant == _FWD_STREAM:
            return _stream_plan(FwdPlan, _FWD_STREAM, d, b, u)
        res = _res_variant(_FWD_RES_UNITS, _FWD_RES[0], u, variant)
        if res is not None:
            return _fwd_res_plan(res, d, b, u)
        if variant is not None:
            raise ValueError(f"variant {variant} does not take U={u}")
        return _stream_plan(FwdPlan, _FWD_STREAM, d, b, u)
    if variant == _FWD_STREAM or variant in _FWD_RES:
        raise ValueError(f"variant {variant} does not take U={u}")
    takes = [v for v in range(len(_FWD_VARIANTS)) if _fwd_clusters(v, u)]
    if u < 4 or u % 4 or not takes:
        raise ValueError(
            f"U={u}: the GRU forward kernel takes U % 4 == 0 with either "
            f"4 <= U <= {_MAX_UNITS} that a cluster size splits evenly "
            f"within a block's threads, or U > {_MAX_UNITS}")

    def plan(v):
        s, _, bt, _ = _FWD_VARIANTS[v]
        fits = _fwd_clusters(v, u)
        c = fits[-1] if v == _FWD_LATENCY else fits[0]
        return FwdPlan(v, bt, c, _warps(u // c * s), (-(-b // bt) * c, d))

    if variant is None:
        variant = takes[0]
        if _FWD_LATENCY in takes:
            latency = plan(_FWD_LATENCY)
            if latency.ctas * latency.threads <= _LATENCY_THREADS:
                variant = _FWD_LATENCY
    elif variant not in takes:
        raise ValueError(f"variant {variant} does not take U={u}")
    return plan(variant)


def _fwd_res_plan(variant: int, d: int, b: int, u: int) -> FwdPlan:
    """A forward resident plan: clusters of C CTAs of ucw S threads per
    (direction, tile of `_res_bt` rows); Rk's chunks i < NR of a lane in
    registers, the NS others and the double-buffered h rows [2, BT, 4 S (NR
    + NS)] f32 in shared memory."""
    c, s, nr, ns, most, _ = _FWD_RESIDENT[variant - _FWD_RES[0]]
    threads = _res_cta_units(u, c) * s
    bt = _res_bt(b, most)
    rk_reg, rk_smem = (threads * n * 3 * 4 * 4 for n in (nr, ns))
    return FwdPlan(variant, bt, c, threads, (-(-b // bt) * c, d), rk_reg,
                   rk_smem, rk_smem + 2 * bt * 4 * s * (nr + ns) * 4)


# csrc/gru_bwd.cu's kVariants: (S lanes splitting a group's k-range, NI
# 4-wide k chunks per lane and gate, BT batch rows per tile, NU units per
# lane group, most threads a block may have); variant v takes U <= 4 * S * NI
# with U % NU == 0. A float4 of dhp read from shared memory feeds 4 NU FMAs:
# the batch and latency variants hold 4 units a group, the wide one (U up
# to 160) and the widest (up to 256) 2.
_BWD_VARIANTS = ((16, 2, 8, 4, 256), (16, 2, 4, 4, 256), (8, 5, 8, 2, 256),
                 (16, 4, 8, 2, 256))
_BWD_BATCH, _BWD_LATENCY, _BWD_WIDE, _BWD_WIDEST, _BWD_STREAM = range(5)
_BWD_MAX_WEIGHTS = 128   # kMaxWeights: Rk values one lane holds in registers
# csrc/gru_bwd.cu's kResident, as _FWD_RESIDENT: (C, S lanes splitting a
# group's k' range of the CTA's 3 ucw dhp values, NR and NS 4-wide k'
# chunks a lane holds in registers and in shared memory, BT the most rows a
# tile, RP rows a pass); a lane group owns 4 output units (kGroupUnits), a
# block 8 ucw threads. Plan indices 5 and 6.
_BWD_RESIDENT = ((8, 4, 6, 3, 40, 4), (16, 2, 9, 3, 40, 4))
_BWD_RES = (5, 6)
_GROUP_UNITS = 4
# the widest U of each: C CTAs of the most units (a multiple of 4) whose 3
# ucw dhp values fit a row of 4 S (NR + NS)
_BWD_RES_UNITS = tuple(c * 4 * (4 * s * (nr + ns) // 12)
                       for c, s, nr, ns, _, _ in _BWD_RESIDENT)


class BwdPlan(NamedTuple):
    """How csrc/gru_bwd.cu's recurrence runs one call: a cluster of `c`
    CTAs of `threads` threads per (direction, tile of `bt` batch rows);
    grid (tiles * c, D); each CTA owns U / NU / c groups of NU units, each
    group S lanes. A resident plan: each CTA owns 4 ceil(U / 4c) units and
    holds `rk_reg` bytes of its Rk slice in registers and `rk_smem` in
    shared memory, of `smem` dynamic shared bytes."""
    variant: int
    bt: int
    c: int
    threads: int
    grid: Tuple[int, int]
    rk_reg: int = 0
    rk_smem: int = 0
    smem: int = 0

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def _bwd_clusters(v: int, u: int) -> list:
    """The cluster sizes on which variant v takes U units."""
    s, ni, _, nu, maxt = _BWD_VARIANTS[v]
    if u > 4 * s * ni or u % nu:
        return []
    return _split_clusters(u // nu, s, maxt)


@functools.lru_cache(maxsize=None)
def _bwd_plan(d: int, b: int, u: int, variant: int = None,
              rk_bf16: bool = False) -> BwdPlan:
    """The backward recurrence's tile plan for D directions, B rows, U
    units, by `_fwd_plan`'s rule: a variant of 4-row tiles over the largest
    cluster that takes U, while its threads fit `_LATENCY_THREADS`; else
    the first variant that takes U (8-row tiles) over the smallest cluster
    that does (U = 128, B = 256: 2 CTAs of 256 threads, 128 CTAs in all);
    past U = 256 the resident recurrence (`_bwd_res_plan`) up to U = 512;
    past it the grid-resident one (`_bwd_grid_plan`) where Rk comes in bf16
    (`rk_bf16`) and it takes (D, B, U), else the streamed one. `variant`
    forces one. Raises on a U no variant takes."""
    if variant == _BWD_GRID or (variant is None and rk_bf16 and
                                _bwd_grid_takes(d, b, u)):
        if not _bwd_grid_takes(d, b, u):
            raise ValueError(f"variant {variant} does not take U={u}, B={b}")
        return _bwd_grid_plan(d, b, u)
    if _takes_streamed(u):
        if variant == _BWD_STREAM:
            return _stream_plan(BwdPlan, _BWD_STREAM, d, b, u)
        res = _res_variant(_BWD_RES_UNITS, _BWD_RES[0], u, variant)
        if res is not None:
            return _bwd_res_plan(res, d, b, u)
        if variant is not None:
            raise ValueError(f"variant {variant} does not take U={u}")
        return _stream_plan(BwdPlan, _BWD_STREAM, d, b, u)
    if variant == _BWD_STREAM or variant in _BWD_RES:
        raise ValueError(f"variant {variant} does not take U={u}")
    takes = [v for v in range(len(_BWD_VARIANTS)) if _bwd_clusters(v, u)]
    if u < 4 or u % 4 or not takes:
        raise ValueError(
            f"U={u}: the GRU backward kernel takes U % 4 == 0 with either "
            f"4 <= U <= {_MAX_UNITS} that a cluster size splits into whole "
            "lane groups evenly within a block's threads, or "
            f"U > {_MAX_UNITS}")

    def plan(v):
        s, _, bt, nu, _ = _BWD_VARIANTS[v]
        fits = _bwd_clusters(v, u)
        c = fits[-1] if bt < 8 else fits[0]
        return BwdPlan(v, bt, c, _warps(u // nu // c * s),
                       (-(-b // bt) * c, d))

    if variant is None:
        variant = takes[0]
        if _BWD_LATENCY in takes:
            latency = plan(_BWD_LATENCY)
            if latency.ctas * latency.threads <= _LATENCY_THREADS:
                variant = _BWD_LATENCY
    elif variant not in takes:
        raise ValueError(f"variant {variant} does not take U={u}")
    return plan(variant)


def _bwd_res_plan(variant: int, d: int, b: int, u: int) -> BwdPlan:
    """A backward resident plan: clusters of C CTAs of 8 ucw threads per
    (direction, tile of `_res_bt` rows); a lane's k' chunks i < NR in
    registers (4 output units each), the NS others, the double-buffered
    slots [2, C, BT, ucw] and the dhp rows [BT, 4 S (NR + NS)] f32 in shared
    memory."""
    c, s, nr, ns, most, _ = _BWD_RESIDENT[variant - _BWD_RES[0]]
    ucw = _res_cta_units(u, c)
    threads = c * ucw // _GROUP_UNITS * s
    bt = _res_bt(b, most)
    rk_reg, rk_smem = (threads * n * _GROUP_UNITS * 4 * 4 for n in (nr, ns))
    smem = rk_smem + (2 * c * bt * ucw + bt * 4 * s * (nr + ns)) * 4
    return BwdPlan(variant, bt, c, threads, (-(-b // bt) * c, d), rk_reg,
                   rk_smem, smem)


def gru_kernel_applicable(units: int) -> bool:
    """Whether the GRU kernels take U units (any batch): what `_fwd_plan`
    and `_bwd_plan` both plan for, U % 4 == 0 with 4 <= U <= 256 where a
    cluster size splits U evenly within a variant's threads, or U > 256."""
    if _takes_streamed(units):
        return True
    return units >= 4 and units % 4 == 0 and \
        any(_fwd_clusters(v, units) for v in range(len(_FWD_VARIANTS))) and \
        any(_bwd_clusters(v, units) for v in range(len(_BWD_VARIANTS)))


def gru_route(units: int, masked: bool = False) -> str:
    """How `gru_forward` runs the recurrence: "masked" (`gru_scan_masked`
    under torch's autograd) with recurrent-dropout masks, on every device
    and at every U, as the JAX layer runs `lax.scan` there; else "kernel"
    (`gru_scan`) where `gru_kernel_applicable` holds, else "plain"
    (`gru_scan_ref` under torch's autograd). The plain route takes no U
    that the JAX package's Pallas kernel takes (B % 8 == 0, U % 128 == 0,
    seld_tpu/ops/pallas/gru.py::pallas_gru_applicable): every such U has
    both plans, at any batch and on any device."""
    if masked:
        return "masked"
    if gru_kernel_applicable(units):
        return "kernel"
    return "plain"


def _step_order(d: int, t_steps: int) -> range:
    """Real time indices in scan order: d=0 ascends, d=1 descends."""
    return range(t_steps) if d == 0 else range(t_steps - 1, -1, -1)


def _gates(xp: torch.Tensor, hp: torch.Tensor, u: int):
    z = torch.sigmoid(xp[..., :u] + hp[..., :u])
    r = torch.sigmoid(xp[..., u:2 * u] + hp[..., u:2 * u])
    hcand = torch.tanh(xp[..., 2 * u:] + r * hp[..., 2 * u:])
    return z, r, hcand, hp[..., 2 * u:]


def gru_scan_ref(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                 rec_bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch recurrence with the kernel's layout and f32 gate math.

    x_proj [D, T, B, 3U], rec_kernel [D, U, 3U], rec_bias [D, 3U] ->
    hs [D, T, B, U] in x_proj's dtype; d=1 runs in descending time and its
    states land at their real t.
    """
    d_dirs, t_steps, b, k = x_proj.shape
    u = k // 3
    rk = rec_kernel.float()
    rb = rec_bias.float()
    hs = torch.empty((d_dirs, t_steps, b, u), dtype=torch.float32,
                     device=x_proj.device)
    for d in range(d_dirs):
        h = torch.zeros((b, u), dtype=torch.float32, device=x_proj.device)
        for t in _step_order(d, t_steps):
            hp = h @ rk[d] + rb[d]
            z, _, hcand, _ = _gates(x_proj[d, t].float(), hp, u)
            h = z * h + (1.0 - z) * hcand
            hs[d, t] = h
    return hs.to(x_proj.dtype)


def in_scan_order(a: torch.Tensor) -> torch.Tensor:
    """[D, T, ...] in real time -> in scan order (d=1 reversed); its own
    inverse."""
    if a.shape[0] == 1:
        return a
    return torch.stack([a[0], a[1].flip(0)])


def gru_scan_masked(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                    rec_bias: torch.Tensor, rec_masks: torch.Tensor
                    ) -> torch.Tensor:
    """`gru_scan_ref` with recurrent dropout: each gate's product
    h_{t-1} @ Rk[:, gate] takes h_{t-1} times that gate's mask
    (rec_masks [D, 3, B, U], constant over time), as the JAX layer's
    `lax.scan` step does (seld_tpu/models/layers.py:504-512). Plain
    PyTorch under autograd on every device, both directions a step, f32
    gate math; hs [D, T, B, U] in x_proj's dtype at real t."""
    d_dirs, t_steps, b, k = x_proj.shape
    u = k // 3
    rk = rec_kernel.float().reshape(d_dirs, u, 3, u)
    rb = rec_bias.float()[:, None]
    masks = rec_masks.float()
    xs = in_scan_order(x_proj)
    h = x_proj.new_zeros((d_dirs, b, u), dtype=torch.float32)
    hs = []
    for p in range(t_steps):
        hp = torch.einsum("dgbu,dugk->dbgk", h[:, None] * masks,
                          rk).reshape(d_dirs, b, k) + rb
        z, _, hcand, _ = _gates(xs[:, p].float(), hp, u)
        h = z * h + (1.0 - z) * hcand
        hs.append(h)
    return in_scan_order(torch.stack(hs, dim=1)).to(x_proj.dtype)


def gru_scan_bwd_ref(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                     rec_bias: torch.Tensor, hs: torch.Tensor,
                     g: torch.Tensor):
    """Plain PyTorch BPTT: the arithmetic of `_bwd_kernel`
    (seld_tpu/ops/pallas/gru.py:86-109), step by step.

    Each direction walks its scan in reverse (d=0 t downwards, d=1 t
    upwards), recomputes the gates from (h_prev, x_proj) with h_prev the
    stored state of the previous scan step (zero at the scan start), and
    carries dh. All math is f32. Returns (dx_proj in x_proj's dtype,
    drk [D, U, 3U] in rec_kernel's dtype, drb [D, 3U] in rec_bias's dtype).
    """
    d_dirs, t_steps, b, k = x_proj.shape
    u = k // 3
    dev = x_proj.device
    rk = rec_kernel.float()
    rb = rec_bias.float()
    dxp = torch.empty((d_dirs, t_steps, b, k), dtype=torch.float32,
                      device=dev)
    drk = torch.zeros((d_dirs, u, k), dtype=torch.float32, device=dev)
    drb = torch.zeros((d_dirs, k), dtype=torch.float32, device=dev)
    zeros = torch.zeros((b, u), dtype=torch.float32, device=dev)
    for d in range(d_dirs):
        order = list(_step_order(d, t_steps))
        dh = zeros
        for p in range(t_steps - 1, -1, -1):        # scan position, reversed
            t = order[p]
            h_prev = hs[d, order[p - 1]].float() if p > 0 else zeros
            hp = h_prev @ rk[d] + rb[d]
            z, r, hcand, hh = _gates(x_proj[d, t].float(), hp, u)
            dh = dh + g[d, t].float()
            dz = dh * (h_prev - hcand)
            da_h = dh * (1.0 - z) * (1.0 - hcand * hcand)     # pre-tanh
            dr = da_h * hh
            da_z = dz * z * (1.0 - z)
            da_r = dr * r * (1.0 - r)
            dxp[d, t] = torch.cat([da_z, da_r, da_h], dim=-1)
            dhp = torch.cat([da_z, da_r, da_h * r], dim=-1)
            dh = dh * z + dhp @ rk[d].T
            drk[d] += h_prev.T @ dhp
            drb[d] += dhp.sum(0)
    return (dxp.to(x_proj.dtype), drk.to(rec_kernel.dtype),
            drb.to(rec_bias.dtype))


def _check_cuda_args(x_proj, rec_kernel, rec_bias):
    if x_proj.dim() != 4 or x_proj.shape[-1] % 3:
        raise ValueError(f"x_proj must be [D, T, B, 3U]; got "
                         f"{tuple(x_proj.shape)}")
    d, t, b, k = x_proj.shape
    u = k // 3
    if d not in (1, 2):
        raise ValueError(f"x_proj has {d} directions; the kernel takes 1 or 2")
    if tuple(rec_kernel.shape) != (d, u, k) or \
            tuple(rec_bias.shape) != (d, k):
        raise ValueError(f"rec_kernel {tuple(rec_kernel.shape)} / rec_bias "
                         f"{tuple(rec_bias.shape)} do not match x_proj "
                         f"{tuple(x_proj.shape)}")
    if x_proj.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x_proj dtype {x_proj.dtype}; the kernel takes "
                        "float32 or bfloat16")
    for name, w in (("rec_kernel", rec_kernel), ("rec_bias", rec_bias)):
        if w.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} dtype {w.dtype}; the kernel takes "
                            "float32 or bfloat16")
    for name, a in (("x_proj", x_proj), ("rec_kernel", rec_kernel),
                    ("rec_bias", rec_bias)):
        if a.device != x_proj.device:
            raise ValueError(f"{name} is on {a.device}, x_proj on "
                             f"{x_proj.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if u % 4:
        raise ValueError(f"U={u}: the kernel needs U % 4 == 0")


def _check_cuda_bwd_args(x_proj, rec_kernel, rec_bias, hs, g):
    """The forward's checks, plus hs and g: [D, T, B, U] in x_proj's dtype,
    contiguous, on its device."""
    _check_cuda_args(x_proj, rec_kernel, rec_bias)
    d, t, b, k = x_proj.shape
    for name, a in (("hs", hs), ("g", g)):
        if tuple(a.shape) != (d, t, b, k // 3):
            raise ValueError(f"{name} {tuple(a.shape)} does not match x_proj "
                             f"{tuple(x_proj.shape)}")
        if a.dtype != x_proj.dtype:
            raise TypeError(f"{name} dtype {a.dtype}; x_proj is "
                            f"{x_proj.dtype}")
        if a.device != x_proj.device:
            raise ValueError(f"{name} is on {a.device}, x_proj on "
                             f"{x_proj.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load(_SOURCE)
    lib.seld_gru_fwd.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    lib.seld_gru_fwd.restype = ctypes.c_int
    lib.seld_gru_fwd_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.seld_gru_fwd_workspace_bytes.restype = ctypes.c_size_t
    lib.seld_gru_fwd_grid_blocks.argtypes = [ctypes.c_int] * 4 + \
        [ctypes.POINTER(ctypes.c_int)]
    lib.seld_gru_fwd_grid_blocks.restype = ctypes.c_int
    _declare_tables(lib, "seld_gru_fwd")
    return lib


def _declare_tables(lib, prefix: str) -> None:
    for name in ("variants", "stream_params", "resident", "grid"):
        fn = getattr(lib, f"{prefix}_{name}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    fn = getattr(lib, f"{prefix}_max_clusters")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int


def _resident_table(fn) -> tuple:
    """(the kResident rows, kResidentUnits) a library was built with."""
    buf = (ctypes.c_int * 64)()
    n = fn(buf, 64)
    return (tuple(tuple(buf[6 * i:6 * i + 6]) for i in range(n)),
            buf[6 * n])


def grid_residency(plan, d: int, b: int, u: int, dtype) -> Tuple[int, int]:
    """(CTAs the card holds at once, CTAs the launch needs) of a
    grid-resident plan, read on the current card: blocks a SM times the
    SMs. The kernels raise rather than launch where the first is short of
    the second."""
    out = ctypes.c_int(-1)
    if isinstance(plan, FwdPlan):
        lib = _library()
        err = lib.seld_gru_fwd_grid_blocks(
            d, b, u, int(dtype == torch.bfloat16), ctypes.byref(out))
    else:
        lib = _bwd_library()
        err = lib.seld_gru_bwd_grid_blocks(d, b, u, ctypes.byref(out))
    kernels.check(lib, err, "grid-resident occupancy")
    return out.value * torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count, plan.ctas


def library_grid() -> tuple:
    """The grid-resident constants compiled into csrc/gru_fwd.cu and
    gru_bwd.cu, each followed by its plan index, to hold (`_GRID_FWD`,
    `_FWD_GRID`) and (`_GRID_BWD`, `_BWD_GRID`) against (loads both)."""
    buf = (ctypes.c_int * 16)()
    fwd = tuple(buf[:_library().seld_gru_fwd_grid(buf, 16)])
    bwd = tuple(buf[:_bwd_library().seld_gru_bwd_grid(buf, 16)])
    return fwd, bwd


def max_active_clusters(plan, d: int, b: int, u: int) -> int:
    """cudaOccupancyMaxActiveClusters of a resident plan's launch
    (`FwdPlan` or `BwdPlan`), read on the current card."""
    lib = _library() if isinstance(plan, FwdPlan) else _bwd_library()
    fn = lib.seld_gru_fwd_max_clusters if isinstance(plan, FwdPlan) else \
        lib.seld_gru_bwd_max_clusters
    out = ctypes.c_int(-1)
    kernels.check(lib, fn(d, b, u, plan.variant, plan.bt, ctypes.byref(out)),
                  "cudaOccupancyMaxActiveClusters")
    return out.value


def _stream_params(fn) -> tuple:
    buf = (ctypes.c_int * 8)()
    return tuple(buf[:fn(buf, 8)])


def library_variants() -> tuple:
    """The variant table compiled into csrc/gru_fwd.cu, its streamed
    variant's constants and its resident table with kResidentUnits, to hold
    `_FWD_VARIANTS`, `_STREAM` and (`_FWD_RESIDENT`, `_RESIDENT_UNITS`)
    against (loads the library)."""
    buf = (ctypes.c_int * 64)()
    n = _library().seld_gru_fwd_variants(buf, 64)
    return (tuple(tuple(buf[4 * i:4 * i + 4]) for i in range(n)),
            _stream_params(_library().seld_gru_fwd_stream_params),
            _resident_table(_library().seld_gru_fwd_resident))


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = kernels.load(_BWD_SOURCE)
    lib.seld_gru_bwd.argtypes = [ctypes.c_void_p] * 9 + \
        [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    lib.seld_gru_bwd.restype = ctypes.c_int
    lib.seld_gru_bwd_workspace_bytes.argtypes = [ctypes.c_int] * 4
    lib.seld_gru_bwd_workspace_bytes.restype = ctypes.c_size_t
    lib.seld_gru_bwd_grid_blocks.argtypes = [ctypes.c_int] * 3 + \
        [ctypes.POINTER(ctypes.c_int)]
    lib.seld_gru_bwd_grid_blocks.restype = ctypes.c_int
    _declare_tables(lib, "seld_gru_bwd")
    return lib


def library_bwd_variants() -> tuple:
    """The variant table compiled into csrc/gru_bwd.cu, its streamed
    recurrence's constants and its resident table with kResidentUnits, to
    hold `_BWD_VARIANTS`, `_STREAM` and (`_BWD_RESIDENT`, `_RESIDENT_UNITS`)
    against (loads the library)."""
    buf = (ctypes.c_int * 64)()
    n = _bwd_library().seld_gru_bwd_variants(buf, 64)
    return (tuple(tuple(buf[5 * i:5 * i + 5]) for i in range(n)),
            _stream_params(_bwd_library().seld_gru_bwd_stream_params),
            _resident_table(_bwd_library().seld_gru_bwd_resident))


def _gru_scan_cuda(x_proj, rec_kernel, rec_bias, plan=None):
    """Launch csrc/gru_fwd.cu on `plan` (`_fwd_plan`'s by default)."""
    _check_cuda_args(x_proj, rec_kernel, rec_bias)
    d, t, b, k = x_proj.shape
    u = k // 3
    if plan is None:
        plan = _fwd_plan(d, b, u, rk_bf16=rec_kernel.dtype == torch.bfloat16)
    if plan.variant == _FWD_GRID and rec_kernel.dtype != torch.bfloat16:
        raise TypeError("the grid-resident plan takes rec_kernel in bf16")
    hs = torch.empty((d, t, b, u), dtype=x_proj.dtype, device=x_proj.device)
    if hs.numel() == 0:
        return hs
    # weights are tiny ([D, U, 3U]); the kernel reads them as f32
    rk = rec_kernel.float().contiguous()
    rb = rec_bias.float().contiguous()
    lib = _library()
    workspace = None
    is_bf16 = int(x_proj.dtype == torch.bfloat16)
    if plan.variant in (_FWD_STREAM, _FWD_GRID):
        # the streamed variant's f32 states, exchanged between a cluster's
        # CTAs; the grid-resident one's step counters and state parts
        workspace = torch.empty(
            lib.seld_gru_fwd_workspace_bytes(d, b, u, plan.variant),
            dtype=torch.uint8, device=x_proj.device)
    kernels.launch("gru_scan", lib.seld_gru_fwd, "gru_fwd launch",
                   x_proj.get_device(), x_proj.data_ptr(), rk.data_ptr(),
                   rb.data_ptr(), hs.data_ptr(),
                   0 if workspace is None else workspace.data_ptr(),
                   d, t, b, u, is_bf16, plan.variant, plan.c, plan.bt,
                   rec_kernel.data_ptr())
    return hs


def _tma_rows(a: torch.Tensor) -> torch.Tensor:
    """`a` as the tensor-core passes read it: as it is where its rows (the
    last dimension) are a multiple of 16 bytes, as TMA loads them, else an
    f32 copy (a bf16 array with U % 8 == 4; U % 4 == 0 holds)."""
    return a if a.shape[-1] * a.element_size() % 16 == 0 else a.float()


def _gru_scan_bwd_cuda(x_proj, rec_kernel, rec_bias, hs, g, plan=None):
    """Launch csrc/gru_bwd.cu on `plan` (`_bwd_plan`'s by default)."""
    _check_cuda_bwd_args(x_proj, rec_kernel, rec_bias, hs, g)
    d, t, b, k = x_proj.shape
    u = k // 3
    if plan is None:
        plan = _bwd_plan(d, b, u, rk_bf16=rec_kernel.dtype == torch.bfloat16)
    if plan.variant == _BWD_GRID and rec_kernel.dtype != torch.bfloat16:
        raise TypeError("the grid-resident plan takes rec_kernel in bf16")
    dev = x_proj.device
    dxp = torch.empty_like(x_proj)
    if dxp.numel() == 0:
        return (dxp, torch.zeros_like(rec_kernel), torch.zeros_like(rec_bias))
    rk = rec_kernel.float().contiguous()
    rb = rec_bias.float().contiguous()
    # what the hp and dRk passes read: Rk and hs as they come, where TMA
    # can load their rows
    rk_pass, hs_pass = _tma_rows(rec_kernel), _tma_rows(hs)
    lib = _bwd_library()
    # scratch of the three passes (hp, then dhp, and the dRk partials; past
    # U = 256 the streamed recurrence's carry and Rk^T), laid out by
    # csrc/gru_bwd.cu
    workspace = torch.empty(lib.seld_gru_bwd_workspace_bytes(d, t, b, u),
                            dtype=torch.uint8, device=dev)
    drk = torch.empty((d, u, k), dtype=torch.float32, device=dev)
    drb = torch.empty((d, k), dtype=torch.float32, device=dev)
    kernels.launch("gru_scan_bwd", lib.seld_gru_bwd, "gru_bwd launch",
                   dev.index, x_proj.data_ptr(), rk.data_ptr(),
                   rb.data_ptr(), hs.data_ptr(), g.data_ptr(),
                   dxp.data_ptr(), workspace.data_ptr(), drk.data_ptr(),
                   drb.data_ptr(), d, t, b, u,
                   int(x_proj.dtype == torch.bfloat16), plan.variant,
                   plan.c, plan.bt, rk_pass.data_ptr(),
                   int(rk_pass.dtype == torch.bfloat16), hs_pass.data_ptr(),
                   int(hs_pass.dtype == torch.bfloat16))
    return dxp, drk.to(rec_kernel.dtype), drb.to(rec_bias.dtype)


def gru_scan_bwd(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
                 rec_bias: torch.Tensor, hs: torch.Tensor, g: torch.Tensor):
    """BPTT of `gru_scan`: (dx_proj, drk, drb) for the cotangent g of hs.

    A CPU tensor runs `gru_scan_bwd_ref`; a CUDA tensor runs the kernel of
    csrc/gru_bwd.cu or raises."""
    if x_proj.device.type == "cpu":
        return gru_scan_bwd_ref(x_proj, rec_kernel, rec_bias, hs, g)
    if x_proj.device.type == "cuda":
        return _gru_scan_bwd_cuda(x_proj, rec_kernel, rec_bias, hs, g)
    raise ValueError(f"gru_scan_bwd runs on cpu or cuda, not "
                     f"{x_proj.device}")


class _GRUScan(torch.autograd.Function):
    """hs = scan(x_proj, rec_kernel, rec_bias); the backward recomputes the
    gates from the saved residuals, as the JAX custom VJP does
    (seld_tpu/ops/pallas/gru.py:336-347)."""

    @staticmethod
    def forward(ctx, x_proj, rec_kernel, rec_bias):
        if x_proj.device.type == "cpu":
            hs = gru_scan_ref(x_proj, rec_kernel, rec_bias)
        elif x_proj.device.type == "cuda":
            hs = _gru_scan_cuda(x_proj, rec_kernel, rec_bias)
        else:
            raise ValueError(f"gru_scan runs on cpu or cuda, not "
                             f"{x_proj.device}")
        ctx.save_for_backward(x_proj, rec_kernel, rec_bias, hs)
        return hs

    @staticmethod
    def backward(ctx, g):
        x_proj, rec_kernel, rec_bias, hs = ctx.saved_tensors
        return gru_scan_bwd(x_proj, rec_kernel, rec_bias, hs,
                            g.to(hs.dtype).contiguous())


def gru_scan(x_proj: torch.Tensor, rec_kernel: torch.Tensor,
             rec_bias: torch.Tensor) -> torch.Tensor:
    """Fused GRU recurrence, differentiable in all three arguments.

    Args:
      x_proj:     [D, T, B, 3U] input projection incl. input bias
                  (z|r|h gate layout, Keras order), float32 or bfloat16
      rec_kernel: [D, U, 3U]
      rec_bias:   [D, 3U] recurrent bias (reset_after)

    Returns hs [D, T, B, U] in x_proj's dtype — REAL-time indexed for both
    directions. A CPU tensor runs `gru_scan_ref` (and `gru_scan_bwd_ref` in
    the backward); a CUDA tensor runs the kernels or raises. Gradients come
    back in each argument's own dtype.
    """
    return _GRUScan.apply(x_proj, rec_kernel, rec_bias)


def input_projection(x: torch.Tensor, kernel: torch.Tensor,
                     in_bias: torch.Tensor, gate_masks=None) -> torch.Tensor:
    """x [B, T, I] @ kernel [D, I, G*U] + in_bias [D, G*U] -> x_proj
    [D, T, B, G*U], contiguous, in the promoted dtype: one product for all
    timesteps and directions. With gate_masks [D, G, B, 1, I] (per-gate
    input dropout, constant over time), gate g of direction d projects
    x * gate_masks[d, g] (seld_tpu/ops/pallas/gru.py:365-390)."""
    dt = torch.promote_types(x.dtype, kernel.dtype)
    x, kernel = x.to(dt), kernel.to(dt)
    if gate_masks is None:
        x_proj = torch.einsum("bti,dik->dtbk", x, kernel)
    else:
        d, g, i = kernel.shape[0], gate_masks.shape[1], kernel.shape[1]
        x_proj = torch.einsum(
            "dgbti,digu->dtbgu", x * gate_masks.to(dt),
            kernel.reshape(d, i, g, -1)).flatten(-2)
    return (x_proj + in_bias[:, None, None].to(dt)).contiguous()


def gru_forward(x: torch.Tensor, kernel: torch.Tensor,
                rec_kernel: torch.Tensor, bias: torch.Tensor, *,
                bidirectional: bool, merge_mode: str = "mul",
                gate_masks=None, rec_masks=None) -> torch.Tensor:
    """Full GRU layer forward.

    x [B, T, I]; kernel [D, I, 3U]; rec_kernel [D, U, 3U]; bias [D, 2, 3U];
    gate_masks [D, 3, B, 1, I] and rec_masks [D, 3, B, U] or None (Keras
    input and recurrent dropout). Returns [B, T, U*dirs] ('concat') or
    [B, T, U] (other merges), matching seld_tpu.models.layers.GRU. The
    recurrence runs as `gru_route` says: `gru_scan`, `gru_scan_ref` or
    `gru_scan_masked` under torch's autograd.
    """
    from seld_tpu_torch.models.layers import merge_bidirectional

    # bias[:, 0] is the input bias, bias[:, 1] the recurrent one
    x_proj = input_projection(x, kernel, bias[:, 0], gate_masks)
    route = gru_route(rec_kernel.shape[-2], masked=rec_masks is not None)
    rec_bias = bias[:, 1].contiguous()
    if route == "masked":
        hs = gru_scan_masked(x_proj, rec_kernel, rec_bias, rec_masks)
    else:
        scan = gru_scan if route == "kernel" else gru_scan_ref
        hs = scan(x_proj, rec_kernel, rec_bias)               # [D,T,B,U]
    hs = hs.transpose(1, 2)                                   # [D,B,T,U]
    if not bidirectional:
        return hs[0]
    return merge_bidirectional(hs[0], hs[1], merge_mode)
