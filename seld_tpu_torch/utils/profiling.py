"""Profiling, spans and counters, and step timing
(seld_tpu/utils/profiling.py).

Usage:
    with trace("/tmp/torch-trace"):        # a Chrome trace of the card
        step(...)

    timer = StepTimer(warmup=2, sync=torch.cuda.synchronize)
    for batch in data:
        with timer:
            state, *_ = step(state, ...)
    print(timer.summary())                 # p50/p90/mean wall times + rate

Spans and counters. The program marks its layers with `span(name)` (a
`torch.profiler.record_function` range) and counts work with
`count(name, n)`. Both are on exactly while a torch.profiler profile
records on the calling thread: under `trace()`, `profile_train --trace`,
the benchmark's `--trace 1` or any `torch.profiler.profile` block. There is
no other switch. Off, each costs one check (`span` returns one shared null
context). On, a span is a host range of category `user_annotation` in the
profiler's trace, on the clock of the card's kernels, nested in the span
that encloses it on the same thread; a count adds to `counts`. A worker
thread the profiler was not started on records nothing.

  seld.train.epoch        one `make_train_epoch` call (train/steps.py):
                          the host's time an epoch, its replays inside
  seld.train.replay       one replay of a step's CUDA graph
                          (train/graphs.py): how long the host stays in
                          the launch, i.e. whether it runs ahead
  seld.train.capture      a step graph's warm-up and capture: a graph built
                          (again), e.g. after a TDM rebuild
  seld.feed.epoch_index   `DeviceDataset.epoch_index_matrix`: the host
                          shuffle and the index upload an epoch waits on
  seld.score.frontend     `ops/frontend.py::fused_foa_frontend`
  seld.score.normalize    `ops/features.py::apply_normalizer`
  seld.score.ensemble     `inference/ensemble.py::ensemble_outputs`
  seld.score.trunk        the fast paths' trunk over whole clips
  seld.score.windows      one chunk's window gather and forward (the head's
                          on the fast paths, padding included)
  seld.score.overlap_add  a clip's overlap-add and normalisation

  counts["score.windows"]      windows the outputs need (n_win a clip)
  counts["score.window_rows"]  rows the windowed model stage ran, padding
                               included: their ratio is the share of
                               useful rows

No span sits inside a captured step body: it would run at the capture
and never at a replay, so a graph's device split is read from its
kernels. `ops/kernels.py::launch_counts` is the always-on proof that a
hand-written kernel ran, not a trace counter.

The JAX package's `enable_compilation_cache` (XLA's persistent compile
cache) and `configure_fast_rng` (XLA's rbg PRNG) have no PyTorch
counterpart: the port compiles its kernels once a machine into build/
(ops/kernels.py), and its masks come from torch.Generator. They are not
ported.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"

# what `count` adds to while a profiler records; `trace()` clears it
counts: collections.Counter = collections.Counter()
_counts_lock = threading.Lock()
_NULL_SPAN = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """A context manager marking `name` on the profiler's timeline: a
    `torch.profiler.record_function` while a profiler records on this
    thread, else one shared null context (no allocation, nothing
    recorded)."""
    if not _recording():
        return _NULL_SPAN
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to `counts[name]` while a profiler records on this thread
    (under a lock: the thread may be one of several), else nothing.
    `trace()` clears `counts` on entry; under any other profiler they are
    the counts of every profiled block since the process began."""
    if _recording():
        with _counts_lock:
            counts[name] += n


def host_fingerprint() -> str:
    """Short hash identifying this host's ISA and torch version. Covers x86
    ('flags') and arm ('Features') /proc/cpuinfo layouts, plus the machine
    arch so an unrecognized layout still splits per arch."""
    import hashlib
    import platform
    try:
        with open("/proc/cpuinfo") as f:
            isa = next((ln for ln in f
                        if ln.startswith(("flags", "Features"))), "")
    except OSError:
        isa = ""
    return hashlib.sha1(
        (platform.machine() + isa + torch.__version__).encode()
    ).hexdigest()[:12]


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block (host and card), written as a Chrome
    trace `logdir/trace.json` (Perfetto, chrome://tracing,
    utils/trace_analysis.py); yields the profiler. The program's spans
    and `counts` record inside it; `counts` is cleared on entry."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with _counts_lock:
        counts.clear()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class StepTimer:
    """Wall-clock step timer with device sync and warmup exclusion.

    A card's kernels run after the call that queued them returns: either
    synchronise inside the timed region yourself or pass ``sync``, a
    zero-argument callable that waits for the step (`torch.cuda.
    synchronize`), which the timer calls before it reads the clock.
    """

    def __init__(self, warmup: int = 2, sync=None):
        self.warmup = warmup
        self._times = []
        self._t0: Optional[float] = None
        if sync is not None and not callable(sync):
            raise TypeError("sync must be a zero-argument callable that "
                            "waits for the step (torch.cuda.synchronize)")
        self._sync = sync

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            self._sync()
        self._times.append(time.perf_counter() - self._t0)
        return False

    def observe(self, result=None):
        """Alternative API: call after each step (`result`, a tensor or a
        sequence of them, is waited for first: its card's work ends)."""
        if result is not None:
            _wait(result)
        now = time.perf_counter()
        if self._t0 is not None:
            self._times.append(now - self._t0)
        self._t0 = now

    @property
    def times(self) -> np.ndarray:
        return np.asarray(self._times[self.warmup:])

    def summary(self, items_per_step: Optional[int] = None
                ) -> Dict[str, float]:
        t = self.times
        if len(t) == 0:
            return {}
        out = {
            "steps": int(len(t)),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "total_s": float(t.sum()),
            "steps_per_sec": float(1.0 / t.mean()),
        }
        if items_per_step:
            out["items_per_sec"] = float(items_per_step / t.mean())
        return out

    def reset(self):
        self._times = []
        self._t0 = None


def _wait(result) -> None:
    """Wait for the card's work that produced `result`."""
    tensors = [result] if isinstance(result, torch.Tensor) else [
        t for t in result if isinstance(t, torch.Tensor)]
    for t in tensors:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


def device_memory_stats(device=None) -> dict:
    """The card's allocator counters, keyed as the JAX package's PJRT
    stats (bytes_in_use, peak_bytes_in_use, bytes_limit) plus
    bytes_reserved; an empty dict for the CPU, which reports none."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                device).total_memory}


def format_memory_stats(stats: dict) -> str:
    if not stats:
        return "memory stats unavailable on this backend"
    gib = 1 << 30
    parts = []
    for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
        if key in stats:
            parts.append(f"{key}={stats[key] / gib:.2f}GiB")
    return ", ".join(parts) or str(stats)
