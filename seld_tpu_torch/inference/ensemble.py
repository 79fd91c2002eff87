"""Sliding-window overlap-add inference (seld_tpu/inference/ensemble.py).

Each full clip is framed into win=300-feature-frame windows at step=5, the
windows go through the model in as few chunks as `batch_size` allows, all
of equal rows (at most `batch_size`, rounded up to a multiple of 8 a shard
of the data axis: a 60-s clip's 541 windows at 512 run as 2 x 272 rows),
and the per-window label-domain outputs are averaged back into one
sequence by overlap-add normalised by window counts (the reference's
trainv2.py:158-192 and make_answer.py:21-55).

Everything runs on the model's device: the windows are gathered a chunk at
a time by tensor indexing (the 60x-expanded tensor is never built) and the
overlap-add is `index_add_`, as the JAX package leaves both to XLA. The
fast path (`fast=True`) runs the time-local trunk once a clip and slides
only the sequence head; with `clip_batch > 1` it stacks equal-length
clips. The scoring half (DCASE CSVs, the official metric, the threshold
search) stays numpy on the host.

Under a profiler (utils/profiling.py) a call is the span
`seld.score.ensemble`, holding `seld.score.trunk` (the fast paths),
`seld.score.windows` (a chunk's gather and forward) and
`seld.score.overlap_add`; the counts `score.windows` (the windows the
outputs need) and `score.window_rows` (the rows the windowed stage ran,
padding included, over every rank of a mesh) give the share of useful rows.

Over several cards (`mesh`, parallel/mesh.py: one process a card, every
rank holding the same weights and the same clips) each chunk of windows
is split over the `data` axis: a rank runs its `data_index`-th slice and
`collectives.gather_rows` puts the chunk back together in rank order, so
every rank returns every clip's full result. The fast path runs the
trunk whole on every rank (it is time-local and cheap) and splits only the
head's window batch. Without a process group nothing is split or
communicated.

`model` is any SELD model of models.build_model (the fast path: a
`ConvTemporal`); `variables`, when given,
are state_dict tensors the forward uses in place of the model's own
(`torch.func.functional_call`), e.g. the SWA average.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from seld_tpu_torch.parallel import collectives
from seld_tpu_torch.train.metrics import calculate_seld_score
from seld_tpu_torch.train.official_metrics import SELDMetricsOfficial
from seld_tpu_torch.utils import io
from seld_tpu_torch.utils.profiling import count, span

# per-class SED decision thresholds of the shipped submission
# (make_answer.py:156)
DEFAULT_CLASS_THRESHOLDS = np.asarray(
    [0.35, 0.35, 0.3, 0.4, 0.65, 0.6, 0.45, 0.55, 0.3, 0.3, 0.45, 0.3],
    dtype=np.float32)

def _frame_index(n: int, length: int, step: int, device) -> torch.Tensor:
    """[n, length] frame indices of n frames of `length` at stride `step`."""
    return (torch.arange(n, device=device)[:, None] * step
            + torch.arange(length, device=device)[None, :])


def sliding_windows(x: torch.Tensor, win_size: int, step: int
                    ) -> torch.Tensor:
    """[T, ...] -> [n_win, win_size, ...] (tf.signal.frame parity, no pad)."""
    n_win = (x.shape[0] - win_size) // step + 1
    return x[_frame_index(n_win, win_size, step, x.device)]


def overlap_add(frames: torch.Tensor, step: int = 1) -> torch.Tensor:
    """[..., n_win, L, C] -> [..., (n_win-1)*step + L, C] scatter-add (the
    leading axes, e.g. lockstep streams, are independent)."""
    *lead, n, l, c = frames.shape
    idx = _frame_index(n, l, step, frames.device).reshape(-1)
    out = torch.zeros((*lead, (n - 1) * step + l, c), dtype=frames.dtype,
                      device=frames.device)
    return out.index_add_(len(lead), idx, frames.reshape(*lead, n * l, c))


def _chunk_plan(n_win: int, batch_size: int, shards: int
                ) -> Tuple[int, int]:
    """(chunks, rows a chunk) for `n_win` windows in chunks of at most
    `batch_size` rows: as few chunks as `batch_size` allows, each of the
    same rows (one shape a clip length), rounded up to a multiple of 8 a
    shard of the data axis (`shards` ways) so that a chunk splits evenly
    over it. A `batch_size` the axis does not divide raises, on every rank
    alike, before any collective."""
    if batch_size % shards:
        raise ValueError(f"a batch of {batch_size} windows does not shard "
                         f"evenly over the {shards}-way data axis")
    n_chunks = -(-n_win // batch_size)
    pad_to = 8 * shards
    rows = -(-n_win // n_chunks)
    return n_chunks, min(batch_size, -(-rows // pad_to) * pad_to)


def _chunked_windows_forward(source: torch.Tensor, twin: int, tstep: int,
                             n_win: int, batch_size: int, shards: int,
                             forward):
    """Gather [twin]-frame windows of `source` ([T, ...]) at stride `tstep`
    in the chunks of `_chunk_plan` and run `forward` on each chunk (the
    shared machinery of the exact and fast sliding-window paths)."""
    n_chunks, n_rows = _chunk_plan(n_win, batch_size, shards)
    count("score.windows", n_win)
    count("score.window_rows", n_chunks * n_rows)
    win_idx = torch.arange(twin, device=source.device)
    rows = torch.arange(n_rows, device=source.device)
    seds, doas = [], []
    for chunk in range(n_chunks):
        with span("seld.score.windows"):
            starts = (chunk * n_rows + rows) * tstep
            # clamp so padded windows gather valid data (sliced off below)
            starts = starts.clamp(max=source.shape[0] - twin)
            sed, doa = forward(source[starts[:, None] + win_idx[None, :]])
        seds.append(sed)
        doas.append(doa)
    return torch.cat(seds)[:n_win], torch.cat(doas)[:n_win]


def _shards(mesh) -> int:
    """How many ways a window batch splits: the `data` axis's size under a
    process group, else 1 (a rank without a group computes alone)."""
    return mesh.data_size if mesh is not None and mesh.distributed else 1


def _data_ranks(mesh) -> List[int]:
    """The rank that holds each shard of the `data` axis (index 0 on every
    other axis), in shard order."""
    names = tuple(mesh.axes)
    sizes = tuple(mesh.axes[n] for n in names)
    d = names.index("data")
    return [int(np.ravel_multi_index(
        tuple(i if k == d else 0 for k in range(len(names))), sizes))
        for i in range(mesh.data_size)]


def _sharded(forward, mesh):
    """`forward` on this rank's rows of a window batch (a multiple of the
    `data` axis's size: `_chunk_plan`'s chunks and the batched fast path's
    padded batch are), every rank's rows gathered back in order (on every
    rank); `forward` itself without a process group."""
    if mesh is None or not mesh.distributed:
        return forward
    n, i = mesh.data_size, mesh.data_index
    ranks = _data_ranks(mesh)

    def run(windows):
        rows = windows.shape[0] // n
        sed, doa = forward(windows[i * rows:(i + 1) * rows])
        c = sed.shape[-1]
        # one collective for both heads, in f32 (what the overlap-add
        # takes; every backend sums f32)
        with collectives.data_parallel(mesh):
            both = collectives.gather_rows(torch.cat([sed, doa], -1).float())
        if both.shape[0] != n * rows:
            # another axis replicates over the whole group: keep one slot
            # of each data shard
            both = both.view(mesh.world, rows, *both.shape[1:])[ranks]
            both = both.flatten(0, 1)
        return both[..., :c], both[..., c:]
    return run


def _overlap_add_normalized(sed: torch.Tensor, doa: torch.Tensor,
                            win_size: int, step_size: int):
    """Validate the feature/label geometry and overlap-add with count
    normalisation (trainv2.py:158-192 semantics)."""
    n_win, label_win = sed.shape[0], sed.shape[1]
    if win_size % label_win:
        raise ValueError(
            f"win_size={win_size} not a multiple of the model's label "
            f"window {label_win}")
    multiplier = win_size // label_win
    if step_size % multiplier:
        raise ValueError(
            f"step_size={step_size} must be a multiple of the feature/label "
            f"frame multiplier {multiplier} (win {win_size} -> {label_win} "
            f"label frames)")
    label_step = step_size // multiplier
    with span("seld.score.overlap_add"):
        # accumulate in f32 whatever the model's compute dtype: a frame
        # receives up to win/step (= 60) overlapping contributions
        sed, doa = sed.float(), doa.float()
        counts = overlap_add(torch.ones((n_win, label_win, 1),
                                        device=sed.device), label_step)
        return (overlap_add(sed, label_step) / counts,
                overlap_add(doa, label_step) / counts)


def _check_fast_geometry(win_size: int, step_size: int, time_down: int):
    if win_size % time_down or step_size % time_down:
        raise ValueError(
            f"fast path needs win_size ({win_size}) and step_size "
            f"({step_size}) divisible by the trunk time stride {time_down}")


def _predict_clip(apply: Callable, x: torch.Tensor, *, win_size: int,
                  step_size: int, batch_size: int, mesh=None):
    """One full clip [T_f, F, C] -> overlap-added (sed [T_l, C],
    doa [T_l, 3C]); each chunk split over `mesh`'s data axis."""
    n_win = (x.shape[0] - win_size) // step_size + 1
    sed, doa = _chunked_windows_forward(x, win_size, step_size, n_win,
                                        batch_size, _shards(mesh),
                                        _sharded(apply, mesh))
    return _overlap_add_normalized(sed, doa, win_size, step_size)


def _predict_clip_fast(apply: Callable, x: torch.Tensor, *, win_size: int,
                       step_size: int, batch_size: int, time_down: int,
                       mesh=None):
    """Fast sliding window: the time-local trunk (stem + conv body) runs
    ONCE over the full clip; only the sequence blocks + heads slide.

    Near-exact rather than exact: the per-window path zero-pads at each
    window's own edges while the full-clip trunk sees the real neighbouring
    frames, so predictions can differ within a conv receptive field of each
    window edge (interior trunk frames are the same). `time_down` (the stem
    pool's time stride for conv_temporal) must divide `step_size`; it is
    checked against the trunk's actual output length.
    """
    t_f = x.shape[0]
    _check_fast_geometry(win_size, step_size, time_down)
    n_win = (t_f - win_size) // step_size + 1
    with span("seld.score.trunk"):
        trunk = apply(x[None], stage="trunk")[0]
    if trunk.shape[0] != t_f // time_down:
        raise ValueError(
            f"time_down={time_down} does not match the model: a "
            f"{t_f}-frame clip produced {trunk.shape[0]} trunk frames "
            f"(expected {t_f // time_down}). Pass the model's actual total "
            f"time downsampling (conv_temporal: first_pool_size[0]).")

    def head(windows):
        return apply(windows, stage="head")

    # the head is a tail of small ops whose cost a clip grows with the
    # number of chunks more than with the number of windows: run all of a
    # clip's windows in one chunk when they fit (a 60-s clip: 541 windows,
    # padded to 544), padded to a multiple of 8 a shard
    eff_batch = batch_size
    shards = _shards(mesh)
    if n_win <= max(batch_size, 1024):
        pad_to = 8 * shards
        eff_batch = -(-n_win // pad_to) * pad_to
    sed, doa = _chunked_windows_forward(
        trunk, win_size // time_down, step_size // time_down, n_win,
        eff_batch, shards, _sharded(head, mesh))
    return _overlap_add_normalized(sed, doa, win_size, step_size)


def _predict_clips_fast_batched(apply: Callable, xs: torch.Tensor, *,
                                win_size: int, step_size: int,
                                time_down: int, mesh=None):
    """Multi-clip fast path: trunks batched over clips, then ALL clips'
    windows run through the sequence head as ONE chunk.

    xs [N, T_f, F, C] -> (sed [N, T_l, C], doa [N, T_l, 3C]); the same as N
    calls of `_predict_clip_fast` (same trunk values by batch independence,
    same head on the same windows) up to the summation order of the
    batch-size-dependent library kernels.
    """
    n, t_f = xs.shape[0], xs.shape[1]
    _check_fast_geometry(win_size, step_size, time_down)
    n_win = (t_f - win_size) // step_size + 1
    with span("seld.score.trunk"):
        trunks = apply(xs, stage="trunk")
    if trunks.shape[1] != t_f // time_down:
        raise ValueError(
            f"time_down={time_down} does not match the model: "
            f"{t_f}-frame clips produced {trunks.shape[1]} trunk frames "
            f"(expected {t_f // time_down})")
    with span("seld.score.windows"):
        idx = _frame_index(n_win, win_size // time_down,
                           step_size // time_down, trunks.device)
        windows = trunks[:, idx]                       # [N, n_win, twin, ..]
        flat = windows.reshape(n * n_win, *windows.shape[2:])
        pad = (-flat.shape[0]) % (8 * _shards(mesh))
        if pad:  # zero rows (not a slice of flat: flat may have < pad rows)
            flat = torch.cat([flat, flat.new_zeros((pad, *flat.shape[1:]))])
        count("score.windows", n * n_win)
        count("score.window_rows", flat.shape[0])
        sed, doa = _sharded(lambda w: apply(w, stage="head"), mesh)(flat)
    sed = sed[: n * n_win].reshape(n, n_win, *sed.shape[1:])
    doa = doa[: n * n_win].reshape(n, n_win, *doa.shape[1:])
    return [_overlap_add_normalized(s, d, win_size, step_size)
            for s, d in zip(sed, doa)]


def _model_device(model: nn.Module, variables: Optional[Dict]):
    src = variables.values() if variables else model.parameters()
    return next(iter(src)).device


def _clip_on(x, device: torch.device) -> torch.Tensor:
    """A clip (numpy array or tensor) on the model's device, dtype kept. A
    host clip is copied to the model's device; a clip on another device
    than the model's (a CUDA clip for a CPU model) is refused, not moved."""
    if isinstance(x, torch.Tensor):
        if x.device.type not in ("cpu", device.type):
            raise ValueError(f"a clip on {x.device} for a model on {device}")
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def ensemble_outputs(model: nn.Module, xs: Sequence,
                     win_size: int = 300, step_size: int = 5,
                     batch_size: int = 256,
                     mesh=None, data_axis: str = "data",
                     fast: bool = False, time_down: int = 5,
                     clip_batch: int = 1,
                     variables: Optional[Dict[str, torch.Tensor]] = None
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-clip sliding-window predictions for a list of full clips, as f32
    tensors on the model's device, the model in eval mode.

    fast=True computes the time-local trunk once per clip and slides only
    the sequence blocks + heads (conv_temporal only; requires
    step_size % time_down == 0, where time_down is the stem pool's time
    stride); near-exact (see `_predict_clip_fast`). The exact path stays
    the default and the parity baseline. clip_batch > 1 (with fast) stacks
    consecutive equal-length clips with all their windows in one head
    chunk.

    A clip's windows run in ceil(n_win / batch_size) chunks of equal rows:
    ceil(n_win / chunks) rounded up to a multiple of 8 x the data axis's
    size, and at most `batch_size`; the rows past n_win are computed and
    dropped. `batch_size` bounds a chunk and sets how many there are.

    `mesh` (parallel.mesh.make_mesh under a process group; every rank calls
    this with the same weights and clips) splits each window batch over
    its `data` axis and gathers the rows back: every rank returns the full
    result. A `batch_size` the axis does not divide raises (as
    `shard_batch` does), on the exact path and for a fast-path clip too
    long for one chunk; the fast path's one-chunk head batch (and
    clip_batch's stacked one) is padded to a multiple of 8 x the axis's
    size, so it always divides. Without a process group (world 1) this
    is the single-card path, bit for bit.
    """
    if mesh is not None and data_axis != "data":
        raise ValueError(f"data_axis {data_axis!r}: the port's meshes shard "
                         "batches over 'data' alone")
    device = _model_device(model, variables)

    def apply(x, stage="full"):
        # only conv_temporal takes `stage`; every model runs "full"
        kwargs = {} if stage == "full" else {"stage": stage}
        if variables is None:
            return model(x, **kwargs)
        return torch.func.functional_call(model, variables, (x,), kwargs)

    was_training = model.training
    model.eval()
    try:
        with span("seld.score.ensemble"), torch.inference_mode():
            return _ensemble_outputs(apply, xs, device, win_size, step_size,
                                     batch_size, fast, time_down, clip_batch,
                                     mesh)
    finally:
        model.train(was_training)


def _ensemble_outputs(apply, xs, device, win_size, step_size, batch_size,
                      fast, time_down, clip_batch, mesh):
    if fast and clip_batch > 1:
        # group consecutive equal-shape clips into stacked batches
        outs: List = [None] * len(xs)
        i = 0
        while i < len(xs):
            group = [i]
            while (len(group) < clip_batch and i + len(group) < len(xs)
                   and tuple(xs[i + len(group)].shape)
                   == tuple(xs[i].shape)):
                group.append(i + len(group))
            if len(group) == 1:
                outs[i] = _predict_clip_fast(
                    apply, _clip_on(xs[i], device), win_size=win_size,
                    step_size=step_size, batch_size=batch_size,
                    time_down=time_down, mesh=mesh)
            else:
                stacked = torch.stack([_clip_on(xs[j], device)
                                       for j in group])
                batched = _predict_clips_fast_batched(
                    apply, stacked, win_size=win_size, step_size=step_size,
                    time_down=time_down, mesh=mesh)
                for j, out in zip(group, batched):
                    outs[j] = out
            i += len(group)
        return outs

    predict = _predict_clip_fast if fast else _predict_clip
    kwargs = {"time_down": time_down} if fast else {}
    return [predict(apply, _clip_on(x, device), win_size=win_size,
                    step_size=step_size, batch_size=batch_size, mesh=mesh,
                    **kwargs)
            for x in xs]


def average_ensemble(model_outputs: Sequence[Sequence[Tuple]]
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Average (sed, doa) across models: [model][clip] -> [clip]
    (make_answer.py:133-140)."""
    outputs = []
    for per_clip in zip(*model_outputs):
        seds, doas = zip(*per_clip)
        outputs.append((sum(seds) / len(seds), sum(doas) / len(doas)))
    return outputs


def _host(a) -> np.ndarray:
    """A prediction as a host numpy array (a device tensor is copied)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def evaluate_clips_official(outputs: Sequence[Tuple], label_names: Sequence[str],
                            gt_dir: str, output_dir: str,
                            thresholds=0.5, n_classes: int = 12,
                            gt_polar: bool = True,
                            doa_threshold: float = 20.0):
    """Write DCASE CSVs for predictions and score with the official metric.

    Parity: generate_evaluate_fn (trainv2.py:195-237) / make_answer.py:159-176.
    Returns (seld_score, (ER, F, LE, LR)).
    """
    os.makedirs(output_dir, exist_ok=True)
    scorer = SELDMetricsOfficial(doa_threshold=doa_threshold,
                                 nb_classes=n_classes)
    for name, (sed, doa) in zip(label_names, outputs):
        sed = _host(sed)
        doa = _host(doa)
        answer_class = sed > thresholds
        io.write_answer(output_dir, name + ".csv", answer_class, doa)
        pred = io.load_output_format_file(
            os.path.join(output_dir, name + ".csv"))
        pred = io.segment_labels(pred, answer_class.shape[0])
        gt = io.load_output_format_file(os.path.join(gt_dir, name + ".csv"))
        if gt_polar:
            gt = io.convert_output_format_polar_to_cartesian(gt)
        gt = io.segment_labels(gt, answer_class.shape[0])
        scorer.update_seld_scores(pred, gt)

    metric_values = scorer.compute_seld_scores()
    return float(calculate_seld_score(metric_values)), metric_values


def search_thresholds(outputs, label_names, gt_dir: str, output_dir: str,
                      n_classes: int = 12,
                      candidates=(0.3, 0.35, 0.4, 0.45, 0.55, 0.6, 0.65, 0.7),
                      gt_polar: bool = True, verbose: bool = False):
    """Greedy per-class SED threshold search on a validation split
    (search_best.py / analyzer.py __main__ threshold-sweep machinery).

    Coordinate descent: sweep each class's threshold over `candidates`,
    keeping the best SELD score; one pass over all classes.
    Returns (best_thresholds [n_classes], best_score).
    """
    outputs = [(_host(s), _host(d)) for s, d in outputs]
    thresholds = np.full(n_classes, 0.5, np.float32)

    def score_with(th):
        seld, _ = evaluate_clips_official(
            outputs, label_names, gt_dir, output_dir,
            thresholds=th, n_classes=n_classes, gt_polar=gt_polar)
        return seld

    best = score_with(thresholds)
    for cls in range(n_classes):
        for cand in candidates:
            trial = thresholds.copy()
            trial[cls] = cand
            s = score_with(trial)
            if s < best:
                best = s
                thresholds = trial
        if verbose:
            print(f"class {cls}: th={thresholds[cls]:.2f} seld={best:.5f}")
    return thresholds, best
