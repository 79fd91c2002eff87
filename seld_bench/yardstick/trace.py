"""Reduce a torch.profiler trace of the card to what the metrics read.

`DeviceTrace.from_profile(prof)` keeps the device's operations (kernels,
copies, fills) and the host's operators as (name, start, end) in seconds.
The device's busy time is the union of its operations' intervals, so two
streams that overlap count once; the idle share is what the union leaves
of the traced window's wall time.

`family` is a frozen copy of the program's grouping of kernels by name
prefix (its five hand-written kernels, library GEMMs, convolutions,
elementwise and reduction passes, the rest).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

PORT_KERNELS = {"gru_scan": ("gru_fwd_",), "gru_scan_bwd": ("gru_bwd_",),
                "stem_dy": ("stem_dy_",), "foa_frontend": ("foa_frontend_",),
                "gather_rows": ("gather_rows_",)}
GEMM_WORDS = ("gemm", "xmma", "cutlass", "cublas", "matmul", "aten::mm",
              "aten::addmm", "aten::bmm")
CONV_WORDS = ("conv", "cudnn", "implicit", "winograd", "wgrad", "dgrad")
ELEMENTWISE_WORDS = ("elementwise", "foreach", "multi_tensor", "reduce",
                     "aten::add", "aten::mul", "aten::sub", "aten::div",
                     "aten::where", "aten::copy_", "aten::sum", "aten::mean")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def family(name: str) -> str:
    """A device operation's family: a port kernel's name, "gemm", "conv",
    "elementwise" or "other"."""
    for kernel, prefixes in PORT_KERNELS.items():
        if any(p in name for p in prefixes):
            return kernel
    low = name.lower()
    if any(w in low for w in CONV_WORDS):
        return "conv"
    if any(w in low for w in GEMM_WORDS):
        return "gemm"
    if any(w in low for w in ELEMENTWISE_WORDS):
        return "elementwise"
    return "other"


class Op(NamedTuple):
    name: str
    start: float    # seconds
    end: float


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted, disjoint intervals covering the same points."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class DeviceTrace:
    def __init__(self, device_ops: List[Op], host_ops: List[Op],
                 start: float, end: float):
        """`start`, `end`: the traced window's bounds, in the ops' clock."""
        self.device_ops = [o for o in device_ops
                           if o.end > start and o.start < end]
        self.host_ops = host_ops
        self.start, self.end = start, end

    @classmethod
    def from_chrome(cls, events: List[Dict], window: Optional[Tuple] = None
                    ) -> "DeviceTrace":
        """From a Chrome trace's events; `window` the traced window as (start,
        end) seconds in the trace's clock, else the span of the device's
        operations."""
        dev, host = [], []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            op = Op(ev.get("name", "?"), float(ev["ts"]) * 1e-6,
                    (float(ev["ts"]) + float(ev.get("dur", 0.0))) * 1e-6)
            if cat in DEVICE_CATS:
                dev.append(op)
            elif cat in HOST_CATS:
                host.append(op)
        if window is None:
            window = ((min(o.start for o in dev), max(o.end for o in dev))
                      if dev else (0.0, 0.0))
        return cls(dev, host, *window)

    @classmethod
    def from_profile(cls, prof, window_name: str) -> "DeviceTrace":
        """From a finished `torch.profiler.profile`; the traced window is the
        host span of the `record_function(window_name)` the run wrapped its
        traced items in. The Chrome export goes to a temporary file that is
        removed at once."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        span = [ev for ev in events if ev.get("ph") == "X"
                and ev.get("name") == window_name]
        window = None
        if span:
            s = float(span[0]["ts"]) * 1e-6
            window = (s, s + float(span[0]["dur"]) * 1e-6)
        return cls.from_chrome(events, window)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return union([(max(o.start, self.start), min(o.end, self.end))
                      for o in self.device_ops])

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def seconds_by(self, pick) -> float:
        """Summed device seconds of the operations whose name `pick`
        accepts (overlaps counted as often as they run)."""
        return sum(o.end - o.start for o in self.device_ops if pick(o.name))

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time, by name."""
        total: Dict[str, float] = defaultdict(float)
        for o in self.device_ops:
            total[o.name] += o.end - o.start
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], secs] for name, secs in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time in the window, summed by what the host was
        doing at each gap's middle (its innermost operator there), the n
        largest."""
        busy = self.busy_intervals()
        gaps, prev = [], self.start
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.end > prev:
            gaps.append((prev, self.end))
        host = sorted(self.host_ops, key=lambda o: o.start)
        starts = [o.start for o in host]
        total: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            best = None
            for o in host[:bisect.bisect_right(starts, mid)][-200:]:
                if o.start <= mid <= o.end and (
                        best is None or o.end - o.start < best.end - best.start):
                    best = o
            total[best.name[:160] if best else "(no host operator)"] += e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, secs] for name, secs in top]
