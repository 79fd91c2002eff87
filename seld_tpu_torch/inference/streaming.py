"""Real-time streaming SELD inference (seld_tpu/inference/streaming.py).

The offline path (`ensemble_outputs`) needs the whole clip before it can
frame windows. This module runs the SAME model and the SAME sliding-window
overlap-add incrementally, emitting final label frames a fixed latency of
one window (300 feature frames = 6 s at the challenge geometry) plus one
chunk behind the live input edge: the serving counterpart of the trunk-once
fast path (inference/ensemble.py).

  - the time-local trunk (stem + conv body) is computed incrementally: each
    pushed chunk recomputes only `chunk + 2*halo` trunk frames, where
    `halo` is the trunk's MEASURED edge receptive field (probed
    numerically, not derived from the config);
  - only the newly COMPLETED windows (those whose trunk content is
    settled) run through the sequence head each push;
  - overlap-add partial sums live in a fixed-size ring; a label frame is
    emitted once its last covering window has been processed.

Clip edges: zero features do not give zero trunk frames, while the offline
trunk zero-pads at the pooled level through the convs' SAME padding. So a
stream has three phases, each a fixed-shape device step on tensors:

  - bootstrap: once the first `l_f = (chunk + 2*halo) * time_down` feature
    frames arrive, the trunk runs CLIP-ALIGNED on them and the first
    windows are processed;
  - steady state: one `_stream_step` per chunk; settled trunk frames sit
    >= halo from both buffer edges, where the trunk is translation-
    invariant (what the halo probe certifies);
  - finalize: the last `l_f` real frames run RIGHT-ALIGNED, the remaining
    windows are processed with validity masks, and the ring is flushed.

Everything is batched over `n_streams` LOCKSTEP streams (same geometry and
clip phase, independent content): the trunk runs as one batch and the head
flattens streams x windows, so its GRUs run at B = chunk * n_streams
(bootstrap, steady state) and (chunk + halo) * n_streams (finalize).
n_streams=1 keeps the single-stream API (unbatched arrays in and out).

The engine runs on its model's device. Features come in as host arrays
(one host-to-device copy a device step) and each push makes ONE
device-to-host copy, of the packed [N, rows, sed | doa | cnt] rows of all
its device steps.

Parity contract (tested): concatenating every emitted frame over a clip
equals `ensemble_outputs(..., fast=True)` on the full clip, per stream.

Requires step_size == time_down (window starts land on every trunk frame)
and a measured halo < win // time_down.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
from torch import nn

from seld_tpu_torch.inference.ensemble import (_frame_index, _model_device,
                                               overlap_add)
from seld_tpu_torch.inference.export import INPUT_DTYPES, load_stream_bundle


@contextlib.contextmanager
def _tf32_off():
    """f32 products and convolutions in full f32 (cuBLAS and cuDNN would
    otherwise run TF32 where allowed), flags restored afterwards."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


@torch.inference_mode()
def measure_trunk_halo(model: nn.Module, feat_shape, time_down: int,
                       max_halo: int = 48, tol: float = 1e-5,
                       dtype: Optional[torch.dtype] = None) -> int:
    """Measure the trunk's one-sided receptive field in TRUNK frames.

    Runs the trunk on a random probe and on the probe minus its first
    `max_halo` trunk frames; the last suffix position whose features differ
    from the full run bounds the edge influence. The probe is the JAX
    package's (numpy seed 0), so both measure the same weights alike. On
    the card TF32 is off for the two calls: TF32 rounding would show as
    edge influence.
    """
    t_probe = (3 * max_halo) * time_down
    rng = np.random.RandomState(0)
    probe = rng.randn(t_probe, *feat_shape).astype(np.float32)
    x = torch.from_numpy(probe).to(_model_device(model, None),
                                   dtype or torch.float32)[None]
    cut = max_halo * time_down
    with _tf32_off():
        full = model(x, stage="trunk")[0].float().cpu().numpy()
        suffix = model(x[:, cut:], stage="trunk")[0].float().cpu().numpy()
    diff = np.abs(full[max_halo:] - suffix).reshape(suffix.shape[0], -1)
    scale = max(1.0, float(np.abs(full).max()))
    bad = np.where(diff.max(axis=1) > tol * scale)[0]
    if bad.size and bad[-1] + 1 >= max_halo:
        raise ValueError(
            f"trunk edge influence exceeds the measurable {max_halo} frames "
            "(dilated/global trunk?); streaming needs a time-local trunk")
    halo = int(bad[-1] + 1) if bad.size else 0
    return halo + 1  # +1 safety margin over the measured tolerance edge


def _head_oa(model: nn.Module, buf: torch.Tensor, base: int, n_cand: int,
             twin: int, w0: int, lo: int, hi: int):
    """Run `n_cand` candidate windows per stream (window j =
    buf[:, base+j : base+j+twin], absolute start w0 + j, valid iff
    lo <= w0+j <= hi, shared across streams) through the head in ONE
    flattened batch and overlap-add at stride 1. Returns (sed, doa, cnt)
    f32, spanning n_cand + twin - 1 rows, row 0 = absolute frame w0."""
    n = buf.shape[0]
    windows = buf[:, base + _frame_index(n_cand, twin, 1, buf.device)]
    flat = windows.reshape(n * n_cand, *windows.shape[2:])
    sed_w, doa_w = model(flat, stage="head")
    j = w0 + torch.arange(n_cand, device=buf.device)
    mask = ((j >= lo) & (j <= hi)).float()[None, :, None, None]
    sed_w = sed_w.reshape(n, n_cand, *sed_w.shape[1:]).float() * mask
    doa_w = doa_w.reshape(n, n_cand, *doa_w.shape[1:]).float() * mask
    ones = mask.expand(n, n_cand, twin, 1)
    return overlap_add(sed_w), overlap_add(doa_w), overlap_add(ones)


def _pack(sed_acc, doa_acc, cnt_acc, rows: int) -> torch.Tensor:
    """Emitted rows [sed | doa | cnt] packed into ONE tensor, so a push
    pays a single device-to-host copy."""
    return torch.cat([sed_acc[:, :rows], doa_acc[:, :rows],
                      cnt_acc[:, :rows]], dim=2)


def _slide(acc: torch.Tensor, rows: int, pad: int) -> torch.Tensor:
    """acc without its first `rows` rows, with `pad` zero rows after."""
    return torch.cat([acc[:, rows:],
                      acc.new_zeros((acc.shape[0], pad, *acc.shape[2:]))],
                     dim=1)


@torch.inference_mode()
def _bootstrap_step(model, feats_lf, lo: int, hi: int, *, twin: int,
                    chunk_t: int, halo_t: int):
    """First device work of a clip: trunk over the first l_f feature frames
    CLIP-ALIGNED, settle trunk [0, chunk_t + halo_t), process the first
    chunk_t candidate windows, seed all rings. feats_lf: [N, l_f, F, C]."""
    trunk0 = model(feats_lf, stage="trunk")
    n_set = trunk0.shape[1] - halo_t                   # chunk_t + halo_t
    trunk_buf = torch.cat(
        [trunk0.new_zeros((trunk0.shape[0], twin + chunk_t - n_set,
                           *trunk0.shape[2:])), trunk0[:, :n_set]], dim=1)
    w0 = n_set - twin - chunk_t + 1
    sed_acc, doa_acc, cnt_acc = _head_oa(model, trunk_buf, 1, chunk_t, twin,
                                         w0, lo, hi)
    state = (feats_lf, trunk_buf, sed_acc, doa_acc, cnt_acc)
    return state, _pack(sed_acc, doa_acc, cnt_acc, chunk_t)


@torch.inference_mode()
def _stream_step(model, state, new_feats, w0: int, lo: int, hi: int, *,
                 twin: int, chunk_t: int, halo_t: int, time_down: int):
    """Steady-state push: slide the feature buffer by one chunk (all-real
    frames), recompute the chunk's trunk slice (>= halo from both buffer
    edges), process the chunk_t newly completed windows, slide the
    overlap-add rings, and emit the chunk_t oldest (now complete) rows.
    new_feats: [N, chunk_f, F, C]. Builds new state tensors (never writes
    the old ones), so engines that share a state reference stay apart."""
    feat_buf, trunk_buf, sed_acc, doa_acc, cnt_acc = state
    feat_buf = torch.cat([feat_buf[:, chunk_t * time_down:], new_feats],
                         dim=1)
    trunk_all = model(feat_buf, stage="trunk")
    l_t = trunk_all.shape[1]
    new_trunk = trunk_all[:, l_t - halo_t - chunk_t: l_t - halo_t]
    trunk_buf = torch.cat([trunk_buf[:, chunk_t:], new_trunk], dim=1)
    sed_c, doa_c, cnt_c = _head_oa(model, trunk_buf, 1, chunk_t, twin, w0,
                                   lo, hi)
    sed_acc = _slide(sed_acc, chunk_t, chunk_t) + sed_c
    doa_acc = _slide(doa_acc, chunk_t, chunk_t) + doa_c
    cnt_acc = _slide(cnt_acc, chunk_t, chunk_t) + cnt_c
    state = (feat_buf, trunk_buf, sed_acc, doa_acc, cnt_acc)
    return state, _pack(sed_acc, doa_acc, cnt_acc, chunk_t)


@torch.inference_mode()
def _finalize_step(model, state, feats_lf_last, tail_off: int, w0: int,
                   lo: int, hi: int, *, twin: int, chunk_t: int,
                   halo_t: int):
    """Clip tail: recompute the last l_f real frames RIGHT-ALIGNED (right
    SAME edge correct), splice the corrected tail after the settled ring,
    process the remaining <= chunk_t + halo_t windows (masked), and flush
    the overlap-add carry. Returns packed rows spanning
    twin - 1 + chunk_t + halo_t, row 0 = absolute frame w0."""
    _, trunk_buf, sed_acc, doa_acc, cnt_acc = state
    w_fin = chunk_t + halo_t
    tail = model(feats_lf_last, stage="trunk")
    # pad before slicing, as the JAX package pads before its dynamic slice:
    # a slice past the end would come back short, not clamped
    tail = _slide(tail, 0, w_fin)[:, tail_off: tail_off + w_fin]
    if tail.shape[1] != w_fin:
        raise RuntimeError(f"tail offset {tail_off} leaves {tail.shape[1]} "
                           f"of {w_fin} trunk frames")
    fbuf = torch.cat([trunk_buf, tail], dim=1)
    # remaining candidate windows start right after the last processed one;
    # window j reads fbuf[:, chunk_t + 1 + j : ... + twin]
    sed_c, doa_c, cnt_c = _head_oa(model, fbuf, chunk_t + 1, w_fin, twin,
                                   w0, lo, hi)
    out_rows = sed_acc.shape[1] - chunk_t + w_fin
    return _pack(_slide(sed_acc, chunk_t, w_fin) + sed_c,
                 _slide(doa_acc, chunk_t, w_fin) + doa_c,
                 _slide(cnt_acc, chunk_t, w_fin) + cnt_c, out_rows)


class StreamingSELD:
    """Incremental sliding-window SELD over live feature stream(s).

    >>> sp = StreamingSELD(model, feat_shape=(64, 7))   # model on its card
    >>> for feats_chunk in live_source:            # [n, 64, 7] any n
    ...     for sed, doa in sp.push(feats_chunk):  # final [C]/[3C] frames
    ...         act_on(sed, doa)
    >>> tail = sp.finalize()                       # remaining frames

    `model` is a `ConvTemporal` (models.build_model); the engine puts it in
    eval mode and runs on its device. Emitted frames match
    `ensemble_outputs(fast=True)` on the concatenated input. Feed
    NORMALIZED features (the training normalizer, predict_wav semantics).

    n_streams > 1 serves that many LOCKSTEP feeds (same clip length and
    push cadence, independent content) in one device step per tick: push
    takes [N, n, F, C] and emitted rows are ([N, C], [N, 3C]) pairs.

    chunk: label frames per device step (10 = 1 s at the challenge
    geometry). Emission latency is one window (twin frames) + one chunk.
    dtype: the features' dtype on the device (None: float32); a bf16
    engine takes a bf16 model and dtype=torch.bfloat16.
    """

    def __init__(self, model: nn.Module, feat_shape, *, win_size: int = 300,
                 step_size: int = 5, time_down: int = 5, chunk: int = 10,
                 halo: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, n_streams: int = 1):
        model.eval()
        if halo is None:
            halo = measure_trunk_halo(model, feat_shape, time_down,
                                      dtype=dtype)
        self._init_geometry(feat_shape, win_size, step_size, time_down,
                            chunk, halo, dtype, n_streams)
        self.model = model
        self.device = _model_device(model, None)
        self.live = True         # False: an exported bundle (from_exported)
        self.meta: dict = {}
        self.reset()

    def _init_geometry(self, feat_shape, win_size, step_size, time_down,
                       chunk, halo, dtype, n_streams):
        if step_size != time_down:
            raise ValueError(
                f"streaming requires step_size == time_down (got "
                f"{step_size} vs {time_down}): window starts must land on "
                "every trunk frame")
        if win_size % time_down:
            raise ValueError("win_size must be a multiple of time_down")
        self.time_down = time_down
        self.twin = win_size // time_down
        self.chunk_t = chunk
        self.chunk_f = chunk * time_down
        self.feat_shape = tuple(feat_shape)
        self.dtype = dtype
        self.n_streams = n_streams
        if halo >= self.twin:
            raise ValueError(
                f"trunk halo ({halo}) must be < the window length in trunk "
                f"frames ({self.twin})")
        self.halo_t = halo
        self.l_f = (self.chunk_t + 2 * self.halo_t) * self.time_down

    @classmethod
    def from_exported(cls, path: str, device="cuda") -> "StreamingSELD":
        """An engine from a stream bundle (inference/export.py::
        export_streaming): the model rebuilt from the zoo with the
        bundle's weights (dequantised on `device`), the geometry and the
        halo measured at export from its meta.json; nothing is measured
        again.

        Like the JAX package's exported engines, it serves clips of at
        least l_f feature frames only: finalize() raises for a shorter
        clip, whose one-pass offline step has clip-dependent shapes.
        """
        model, meta = load_stream_bundle(path, device=device)
        self = cls(model, tuple(meta["feat_shape"]),
                   win_size=meta["win_size"], step_size=meta["step_size"],
                   time_down=meta["time_down"], chunk=meta["chunk"],
                   halo=meta["halo"], dtype=INPUT_DTYPES[meta["dtype"]],
                   n_streams=meta["n_streams"])
        self.live = False
        self.meta = meta
        return self

    # ---- bookkeeping ----
    # E = feature frames consumed by the device so far; the settled trunk
    # pointer is A = E // time_down - halo_t. Regular pushes advance E by
    # chunk_f; bootstrap sets E = l_f. A push ending at A emits label
    # frames (A_prev - twin, A - twin] (complete: every covering window
    # processed).

    def _abs_a(self) -> int:
        return self._e // self.time_down - self.halo_t

    def _collect(self, t0: int, emit: np.ndarray, t_end: Optional[int]):
        """Unpack host rows [N, rows, sed | doa | cnt]. Single-stream
        instances emit unbatched ([C], [3C]) pairs."""
        n_sed = (emit.shape[2] - 1) // 4          # doa = 3 * sed
        out = []
        for i in range(emit.shape[1]):
            t = t0 + i
            if t < 0 or (t_end is not None and t >= t_end):
                continue
            c = emit[0, i, -1]
            if c <= 0:
                continue
            sed = emit[:, i, :n_sed] / c
            doa = emit[:, i, n_sed:-1] / c
            if self.n_streams == 1:
                out.append((t, sed[0], doa[0]))
            else:
                out.append((t, sed, doa))
        return out

    def _asdev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device, self.dtype or torch.float32)

    def _check_shape(self, feats: np.ndarray) -> np.ndarray:
        """Accept [n, F, C] for single-stream, [N, n, F, C] otherwise."""
        if self.n_streams == 1 and feats.ndim == len(self.feat_shape) + 1:
            feats = feats[None]
        if (feats.ndim != len(self.feat_shape) + 2
                or feats.shape[0] != self.n_streams
                or feats.shape[2:] != self.feat_shape):
            raise ValueError(
                f"expected [{self.n_streams}, n, {self.feat_shape}] "
                f"features, got {feats.shape}")
        return feats

    def _geometry(self) -> dict:
        return dict(twin=self.twin, chunk_t=self.chunk_t, halo_t=self.halo_t)

    # ---- public API ----

    def push(self, feats: np.ndarray):
        """Feed feature frames; returns [(sed, doa)] for every label frame
        that became FINAL, in order (arrays carry a leading stream axis
        when n_streams > 1)."""
        if self._finalized:
            raise RuntimeError("finalize() already called; call reset() "
                               "for a new clip")
        feats = self._check_shape(np.asarray(feats, np.float32))
        self._pending = np.concatenate([self._pending, feats], axis=1)
        self._fed_f += feats.shape[1]
        big = 1 << 30
        emits, t0 = [], None
        if self._e == 0:
            if self._pending.shape[1] < self.l_f:
                return []
            first, self._pending = (self._pending[:, :self.l_f],
                                    self._pending[:, self.l_f:])
            self.state, emit = _bootstrap_step(
                self.model, self._asdev(first), 0, big, **self._geometry())
            self._e = self.l_f
            t0 = self._abs_a() - self.twin - self.chunk_t + 1
            emits.append(emit)
        while self._pending.shape[1] >= self.chunk_f:
            chunk, self._pending = (self._pending[:, :self.chunk_f],
                                    self._pending[:, self.chunk_f:])
            w0 = self._abs_a() - self.twin + 1
            self.state, emit = _stream_step(
                self.model, self.state, self._asdev(chunk), w0, 0, big,
                time_down=self.time_down, **self._geometry())
            self._e += self.chunk_f
            t0 = w0 if t0 is None else t0
            emits.append(emit)
        if not emits:
            return []
        # each device step's rows start where the previous one's end, so
        # the push's rows leave the device in one copy
        done = self._collect(t0, torch.cat(emits, dim=1).cpu().numpy(),
                             None)
        self._emitted += len(done)
        return [(s, d) for _, s, d in done]

    def finalize(self):
        """Flush the stream; returns the remaining final (sed, doa) frames.
        Total frames over the clip = T_f // time_down, matching the offline
        fast path."""
        if self._finalized:
            return []
        if self._fed_f % self.time_down:
            raise ValueError(
                f"total fed frames ({self._fed_f}) must be a multiple of "
                f"time_down ({self.time_down})")
        t_t = self._fed_f // self.time_down
        if t_t < self.twin:
            raise ValueError(
                f"clip shorter than one window ({t_t} < {self.twin} trunk "
                "frames)")
        # mark finalized only on SUCCESS (end of each path): a finalize that
        # fails (validation above or device work below) must stay
        # retryable (or error again), never silently return [] as if done;
        # host inputs (_pending, state) are left intact until then
        if self._e == 0:
            if not self.live:
                raise RuntimeError(
                    "exported streaming engines serve clips >= "
                    f"{self.l_f} feature frames (this clip has "
                    f"{self._fed_f}); the short-clip pass has "
                    "clip-dependent shapes and needs the live model")
            sed, doa = self._short_clip(t_t)
            self._finalized = True
            self._pending = self._pending[:, :0]
            self._emitted += t_t
            if self.n_streams == 1:
                return list(zip(sed[0], doa[0]))
            return [(sed[:, i], doa[:, i]) for i in range(t_t)]

        # device path: the host keeps the last l_f real frames (_tail_feats)
        a_last = self._abs_a()
        w0 = a_last - self.twin + 1
        tail_off = a_last - (t_t - self.l_f // self.time_down)
        emit = _finalize_step(self.model, self.state,
                              self._asdev(self._tail_feats), tail_off, w0,
                              0, t_t - self.twin, **self._geometry())
        done = self._collect(w0, emit.cpu().numpy(), t_t)
        self._finalized = True
        self._emitted += len(done)
        return [(s, d) for _, s, d in done]

    @torch.inference_mode()
    def _short_clip(self, t_t: int):
        """A clip shorter than l_f features (no device state yet): one
        two-call offline pass (trunk + all windows), clip-aligned at both
        edges by construction. Returns host (sed, doa) [N, t_t, ...]."""
        trunk = self.model(self._asdev(self._pending), stage="trunk")
        n_win = t_t - self.twin + 1
        windows = trunk[:, _frame_index(n_win, self.twin, 1, trunk.device)]
        flat = windows.reshape(self.n_streams * n_win, *windows.shape[2:])
        sed_w, doa_w = self.model(flat, stage="head")
        sed_w = sed_w.reshape(self.n_streams, n_win, *sed_w.shape[1:])
        doa_w = doa_w.reshape(self.n_streams, n_win, *doa_w.shape[1:])
        cnt = overlap_add(torch.ones((self.n_streams, n_win, self.twin, 1),
                                     device=trunk.device))
        return ((overlap_add(sed_w.float()) / cnt).cpu().numpy(),
                (overlap_add(doa_w.float()) / cnt).cpu().numpy())

    @property
    def _tail_feats(self) -> np.ndarray:
        """Last l_f REAL feature frames (for the right-aligned tail)."""
        if self._fed_f < self.l_f:
            raise RuntimeError("fewer than l_f frames fed")
        n_from_pending = self._pending.shape[1]
        need_from_buf = self.l_f - n_from_pending
        feat_buf = self.state[0].float().cpu().numpy()
        return np.concatenate(
            [feat_buf[:, feat_buf.shape[1] - need_from_buf:],
             self._pending], axis=1)

    def reset(self):
        """Start a new clip. The device state is dropped, not cleared in
        place: an engine copied from this one (copy.copy, as the server's
        sessions are) keeps its own."""
        self.state = None
        self._pending = np.zeros((self.n_streams, 0, *self.feat_shape),
                                 np.float32)
        self._e = 0
        self._fed_f = 0
        self._emitted = 0
        self._finalized = False
