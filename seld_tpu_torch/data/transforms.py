"""Batch augmentations on the card (seld_tpu/data/transforms.py).

Each augment is two parts: a draw of its random numbers from a
`torch.Generator` on the batch's device (`draw_*`), and an application
that takes those draws as tensors (`*_apply`). The augment itself,
`fn(generator, x, y) -> (x, y)`, is the two in a row. A test can so hand
the application the numbers the JAX package drew and compare the results
exactly.

  - time/freq masking      `batch_mask`: n_mask random spans per
                           period-frame chunk, as fixed-shape comparisons
  - FOA spatial aug        `foa_intensity_vec_aug`: per-sample axis sign
                           flips + x/z swap, applied consistently to the
                           FOA channels, the IV channels and the cartesian
                           labels
  - audio channel swap     `acs_aug` on the joint 17-channel FOA+MIC
                           input: one of 8 rotations/reflections of the
                           array (arXiv 2101.02919 Table 1) a sample,
                           applied to the FOA channels, the IV channels,
                           the mic mels, the GCC pairs (`mic_gcc_perm`)
                           and the cartesian labels
  - random gain            `random_ups_and_downs` on the log-mel channels
                           (0:4, and 7:11 of the joint input)
  - `compose`
  - `cgmm_mask_aug`        CGMM noise-mask estimation, host-side numpy in
                           float64; not wired into the trainer, as in the
                           JAX package

Inside a data-parallel step every draw is made at the global batch's size
and each rank keeps its rows, so a row's augment does not depend on the
rank count.

The channel-swap tables live on the batch's device, made at the first
call (the warm-up of a captured step runs before its capture), so a step
that applies `acs_aug` makes no host-to-device copy.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from seld_tpu_torch.parallel import collectives


def _randint(gen: torch.Generator, low: int, high: int, shape,
             device) -> torch.Tensor:
    """Integers in [low, high) of `shape`, whose leading dim runs over the
    batch's rows; inside a data-parallel step drawn for the global batch,
    this rank's rows kept (parallel/collectives.py)."""
    draw = torch.randint(low, high,
                         (collectives.global_rows(shape[0]), *shape[1:]),
                         generator=gen, device=device)
    return collectives.rows_of(draw, 0, shape[0])


# ---------------------------------------------------------------------------
# SpecAugment-style masking
# ---------------------------------------------------------------------------
def _mask_geometry(shape, axis: int, period: int) -> Tuple[int, int]:
    """(mask rows, masked length) of `batch_mask` on a [B, T, F, C] batch."""
    b, t, f, _ = shape
    if t % period != 0:
        raise ValueError("(spec time length / period)'s rest must be 0")
    if axis in (-3, 1):
        return b * (t // period), period
    if axis in (-2, 2):
        return b * (t // period), f
    raise ValueError(f"unsupported mask axis: {axis}")


def draw_mask(gen: torch.Generator, shape, axis: int,
              max_mask_size: Optional[int] = None, period: int = 100,
              n_mask: int = 1, device=None):
    """(sizes, offsets) [rows, n_mask] int64: sizes in [0, max_mask_size),
    offsets in [0, masked length)."""
    rows, total = _mask_geometry(shape, axis, period)
    sizes = _randint(gen, 0, max_mask_size or total, (rows, n_mask), device)
    offsets = _randint(gen, 0, total, (rows, n_mask), device)
    return sizes, offsets


def batch_mask_apply(specs: torch.Tensor, axis: int, sizes: torch.Tensor,
                     offsets: torch.Tensor, period: int = 100
                     ) -> torch.Tensor:
    """Zero each row's spans [offset, offset + size) in `specs` [B, T, F, C];
    time spans lie within each `period`-frame chunk (axis -3), frequency
    spans get a fresh draw per chunk (axis -2). Offsets are wrapped by
    max(total - size, 1), as the JAX package keeps its shapes fixed."""
    b, t, f, c = specs.shape
    _, total = _mask_geometry(specs.shape, axis, period)
    offsets = offsets % torch.clamp_min(total - sizes, 1)
    iota = torch.arange(total, device=specs.device)[None, None, :]
    inside = ((iota >= offsets[..., None])
              & (iota < (offsets + sizes)[..., None]))
    keep = (~inside.any(dim=1)).to(specs.dtype)
    nchunk = t // period
    if axis in (-3, 1):
        keep = keep.reshape(b, nchunk, period, 1, 1)
    else:
        keep = keep.reshape(b, nchunk, 1, f, 1)
    x = specs.reshape(b, nchunk, period, f, c)
    return (x * keep).reshape(b, t, f, c)


def batch_mask(gen: torch.Generator, specs: torch.Tensor, axis: int,
               max_mask_size: Optional[int] = None, period: int = 100,
               n_mask: int = 1) -> torch.Tensor:
    """Batched time/freq masking on [B, T, F, C]."""
    sizes, offsets = draw_mask(gen, specs.shape, axis, max_mask_size,
                               period, n_mask, specs.device)
    return batch_mask_apply(specs, axis, sizes, offsets, period)


# ---------------------------------------------------------------------------
# FOA spatial augmentation
# ---------------------------------------------------------------------------
def draw_foa(gen: torch.Generator, batch: int, device=None):
    """(flip [B, 3] in {0, 1}, swap [B, 1] in {0, 1})."""
    flip = _randint(gen, 0, 2, (batch, 3), device)
    swap = _randint(gen, 0, 2, (batch, 1), device)
    return flip, swap


def _batched_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, ..., k] gathered along the last axis by idx [B, k]."""
    idx = idx.reshape(idx.shape[0], *([1] * (x.dim() - 2)), idx.shape[-1])
    return torch.take_along_dim(x, idx.expand(*x.shape[:-1], idx.shape[-1]),
                                dim=-1)


def foa_intensity_vec_aug_apply(x: torch.Tensor, y: torch.Tensor,
                                flip: torch.Tensor, swap: torch.Tensor):
    """x [B, T, F, 7] (4 mel + 3 IV), y [B, T', 4C] -> the equally
    transformed pair, from the draws of `draw_foa`."""
    b = x.shape[0]
    n_classes = y.shape[-1] // 4
    y4 = y.reshape(*y.shape[:-1], 4, n_classes)
    iv = x[..., -3:]
    cart = y4[..., -3:, :]

    flip = flip.to(x.dtype)
    iv = (1 - 2 * flip.reshape(b, 1, 1, 3)) * iv
    cart = (1 - 2 * flip.to(y.dtype).reshape(b, 1, 3, 1)) * cart

    # swap x/z axes half the time: perm = [0,1,2] or [2,1,0]
    p = 2 * swap.long()
    perm = torch.cat([p, torch.ones_like(p), 2 - p], dim=-1)      # [B, 3]
    correct = torch.arange(3, device=x.device)[None]
    check = (perm != correct).long().sum(-1, keepdim=True)
    feat_perm = (perm + check) % 3

    iv = _batched_take(iv, feat_perm)
    cart = _batched_take(cart.transpose(-1, -2), feat_perm).transpose(-1, -2)
    foa = _batched_take(x[..., 1:4], perm)

    x = torch.cat([x[..., :1], foa, iv], dim=-1)
    y4 = torch.cat([y4[..., :-3, :], cart], dim=-2)
    return x, y4.reshape(y.shape)


def foa_intensity_vec_aug(gen: torch.Generator, x: torch.Tensor,
                          y: torch.Tensor):
    flip, swap = draw_foa(gen, x.shape[0], x.device)
    return foa_intensity_vec_aug_apply(x, y, flip, swap)


# 8-way channel-swap table (arXiv 2101.02919 Table 1): [[mic perm], [foa code]]
CHANNEL_LIST = np.asarray([
    [[1, 3, 0, 2], [0, -3, -2, 1]],
    [[3, 1, 2, 0], [0, -3, 2, -1]],
    [[0, 1, 2, 3], [0, 1, 2, 3]],
    [[1, 0, 3, 2], [0, -1, -2, 3]],
    [[2, 0, 3, 1], [0, 3, -2, -1]],
    [[0, 2, 1, 3], [0, 3, 2, 1]],
    [[3, 2, 1, 0], [0, -1, 2, -3]],
    [[2, 3, 0, 1], [0, 1, -2, -3]],
], dtype=np.int32)

# decode_table[m, n] = index of pair (min(m,n), max(m,n)) in the ordered GCC
# pair list [(0,1),(0,2),(0,3),(1,2),(1,3),(2,3)]
_GCC_DECODE = np.asarray([[0, 0, 1, 2],
                          [0, 0, 3, 4],
                          [1, 3, 0, 5],
                          [2, 4, 5, 0]], dtype=np.int32)
_GCC_PAIRS = np.asarray([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                        dtype=np.int32)

_TABLES: Dict[torch.device, Dict[str, torch.Tensor]] = {}


def _tables(device) -> Dict[str, torch.Tensor]:
    """The channel-swap tables as int64 tensors on `device`, made once."""
    device = torch.device(device)
    if device not in _TABLES:
        _TABLES[device] = {
            name: torch.as_tensor(table, dtype=torch.int64, device=device)
            for name, table in (("channels", CHANNEL_LIST),
                                ("decode", _GCC_DECODE),
                                ("pairs", _GCC_PAIRS))}
    return _TABLES[device]


def mic_gcc_perm(mic_perm: torch.Tensor) -> torch.Tensor:
    """[B, 4] mic permutation -> [B, 6] GCC-pair permutation."""
    t = _tables(mic_perm.device)
    res = mic_perm[:, t["pairs"]]                    # [B, 6, 2] permuted pair
    return t["decode"][res[..., 0], res[..., 1]]     # [B, 6]


def draw_acs(gen: torch.Generator, batch: int, device=None) -> torch.Tensor:
    """[B] int64 rows of CHANNEL_LIST, in [0, 8)."""
    return _randint(gen, 0, 8, (batch,), device)


def acs_aug_apply(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor):
    """x [B, T, F, 17] = 4 FOA mel + 3 IV + 4 mic mel + 6 GCC, y [B, T',
    4C] -> the equally transformed pair, sample b by CHANNEL_LIST[idx[b]]
    (the draws of `draw_acs`)."""
    n_classes = y.shape[-1] // 4
    y4 = y.reshape(*y.shape[:-1], 4, n_classes)
    iv = x[..., 4:7]
    cart = y4[..., -3:, :]

    flip = _tables(x.device)["channels"][idx.long()]  # [B, 2, 4]
    foa_flip = flip[:, 1, 1:]                        # [B, 3]
    foa_sign = torch.sign(foa_flip)
    foa_perm = foa_sign * foa_flip - 1               # [B, 3] in {0, 1, 2}
    correct = torch.arange(3, device=x.device)[None]
    check = (foa_perm != correct).long().sum(-1, keepdim=True)
    foa_feat_perm = (foa_perm + check) % 3

    foa_x = _batched_take(x[..., 1:4], foa_perm)
    iv = _batched_take(iv, foa_feat_perm) \
        * foa_sign.to(x.dtype)[:, None, None, :]
    cart = _batched_take(cart.transpose(-1, -2), foa_feat_perm
                         ).transpose(-1, -2) \
        * foa_sign.to(y.dtype)[:, None, :, None]

    mic_flip = flip[:, 0, :]
    gcc = _batched_take(x[..., 11:], mic_gcc_perm(mic_flip))
    mic_x = _batched_take(x[..., 7:11], mic_flip)

    x = torch.cat([x[..., :1], foa_x, iv, mic_x, gcc], dim=-1)
    y4 = torch.cat([y4[..., :-3, :], cart], dim=-2)
    return x, y4.reshape(y.shape)


def acs_aug(gen: torch.Generator, x: torch.Tensor, y: torch.Tensor):
    """Audio-channel-swap augment on the joint FOA+MIC features."""
    return acs_aug_apply(x, y, draw_acs(gen, x.shape[0], x.device))


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------
def split_total_labels_to_sed_doa(x, y):
    n_classes = y.shape[-1] // 4
    return x, (y[..., :n_classes], y[..., n_classes:])


def draw_gain(gen: torch.Generator, device=None) -> torch.Tensor:
    """One N(0, 0.2^2) gain, f32 scalar."""
    return torch.randn((), generator=gen, device=device) * 0.2


def random_ups_and_downs_apply(x: torch.Tensor, y, gain: torch.Tensor):
    """Add `gain` to the log-mel channels: 0:4, and on the joint 17-channel
    input the same scene's mic mels 7:11 too (the same gain, or the pairs
    `acs_aug` and the model see disagree). IV and GCC channels are ratios
    and correlations and stay untouched."""
    if x.shape[-1] == 17:
        return torch.cat([x[..., :4] + gain, x[..., 4:7],
                          x[..., 7:11] + gain, x[..., 11:]], dim=-1), y
    return torch.cat([x[..., :4] + gain, x[..., 4:]], dim=-1), y


def random_ups_and_downs(gen: torch.Generator, x: torch.Tensor, y):
    """Random global gain offset on the log-mel channels."""
    return random_ups_and_downs_apply(x, y, draw_gain(gen, x.device))


def compose(*fns: Callable) -> Callable:
    """Compose generator-driven (x, y) transforms into one augment: each
    draws from the same generator, in order."""
    def augment(gen, x, y):
        for fn in fns:
            x, y = fn(gen, x, y)
        return x, y
    return augment


# ---------------------------------------------------------------------------
# CGMM mask-estimation aug (host-side, float64)
# ---------------------------------------------------------------------------
def cgmm_mask_aug(x: np.ndarray, iterations: int = 3,
                  theta: float = 1e-6) -> np.ndarray:
    """CGMM noisy/noise mask estimation (the cgmm-mask-estimator recipe);
    returns x scaled by the estimated noise mask.

    x: [batch, time, freq, chan] real features. Host-side in float64: the
    EM repeatedly inverts per-bin covariance matrices, which overflows in
    float32. The reference defines this augment but wires it into no
    trainer; neither the JAX package nor the port does.
    """
    x = x.astype(np.float64)
    batch, time, freq, chan = x.shape
    eye = np.eye(chan)

    def stab(mat):
        # progressively add jitter until well-conditioned
        for dd in (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1):
            with np.errstate(all="ignore"):
                cond = np.linalg.cond(mat)
            bad = ~np.isfinite(cond) | (cond > 1e6)
            if not bad.any():
                break
            mat = mat + bad[..., None, None] * dd * eye
        return mat

    xt = x.transpose(0, 2, 3, 1)                       # [b, f, c, t]
    r_noisy = xt @ xt.transpose(0, 1, 3, 2) / time     # [b, f, c, c]
    r_noise = np.tile(eye, (batch, freq, 1, 1))

    yx = x[..., None]                                  # [b, t, f, c, 1]
    yyh = yx @ yx.transpose(0, 1, 2, 4, 3)             # [b, t, f, c, c]

    def safe_div(a, b):
        return a / np.maximum(b, 1e-8)

    r_noisy_inv = np.linalg.inv(stab(r_noisy))
    r_noise_inv = np.linalg.inv(stab(r_noise))
    phi_noisy = np.trace(yyh @ r_noisy_inv[:, None], axis1=-2, axis2=-1) / chan
    phi_noise = np.trace(yyh @ r_noise_inv[:, None], axis1=-2, axis2=-1) / chan

    lambda_noise = np.full((batch, time, freq), 0.5)
    for _ in range(iterations):
        r_noisy_s = stab(r_noisy)
        r_noise_s = stab(r_noise)
        r_noisy_inv = np.linalg.inv(r_noisy_s)
        r_noise_inv = np.linalg.inv(r_noise_s)

        def lik(r_inv, r_s, phi):
            k = (x[..., None, :] @ safe_div(r_inv[:, None],
                                            phi[..., None, None]))
            k = (k @ x[..., None])[..., 0, 0]
            det = np.linalg.det(phi[..., None, None] * r_s[:, None]) * np.pi
            return safe_div(np.exp(-np.clip(k, -700, 700)), det) + theta

        p_noise = lik(r_noise_inv, r_noise_s, phi_noise)
        p_noisy = lik(r_noisy_inv, r_noisy_s, phi_noisy)

        lambda_noise = safe_div(p_noise, p_noise + p_noisy)
        lambda_noisy = safe_div(p_noisy, p_noise + p_noisy)

        phi_noise = np.trace(yyh @ r_noise_inv[:, None],
                             axis1=-2, axis2=-1) / chan
        phi_noisy = np.trace(yyh @ r_noisy_inv[:, None],
                             axis1=-2, axis2=-1) / chan

        acc_noisy = safe_div(lambda_noisy, phi_noisy)[..., None, None] * yyh
        acc_noise = safe_div(lambda_noise, phi_noise)[..., None, None] * yyh
        r_noisy = safe_div(acc_noisy.sum(1),
                           lambda_noisy.sum(1)[..., None, None])
        r_noise = safe_div(acc_noise.sum(1),
                           lambda_noise.sum(1)[..., None, None])

    return (x * lambda_noise[..., None]).astype(np.float32)
