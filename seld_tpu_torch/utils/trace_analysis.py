"""Group a torch.profiler Chrome trace's time by kernel family
(seld_tpu/utils/trace_analysis.py).

Reads the trace `utils.profiling.trace` writes (`<dir>/trace.json`, or any
`export_chrome_trace` file) and sums the durations of one category of its
events, the card's kernels by default, by family, so hotspots show without
a trace viewer:

    report = analyze_trace("/tmp/torch-trace")
    print(format_report(report))

The JAX package groups XLA's ops by HLO opcode (fusion, convolution, dot,
...). The port's families are its own kernels (the six hand-written
CUDA sources, named after the wrappers that launch them), library GEMMs
(the JAX package's dots), convolutions (its convolutions), elementwise
and reduction passes (most of what XLA fuses) and everything else.
`profile_step` groups a step's device time with the same `_classify`, and
takes its idle share from `idle_share`: 1 - the union of the device's
kernel, copy and fill intervals over a traced window's wall time, so two
streams that overlap count once.
"""
from __future__ import annotations

import glob
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

# the port's kernels by the prefixes of their CUDA function names
PORT_KERNELS = {"gru_scan": ("gru_fwd_",),
                "gru_scan_bwd": ("gru_bwd_",),
                "stem_dy": ("stem_dy_",),
                "foa_frontend": ("foa_frontend_",),
                "gather_rows": ("gather_rows_",),
                "batch_norm": ("batch_norm_",)}
GEMM_WORDS = ("gemm", "xmma", "cutlass", "cublas", "matmul", "aten::mm",
              "aten::addmm", "aten::bmm")
CONV_WORDS = ("conv", "cudnn", "implicit", "winograd", "wgrad", "dgrad")
ELEMENTWISE_WORDS = ("elementwise", "foreach", "multi_tensor", "reduce",
                     "aten::add", "aten::mul", "aten::sub", "aten::div",
                     "aten::where", "aten::copy_", "aten::sum", "aten::mean")
# trace event categories: the card's kernels, the host's operators
DEVICE, HOST = "kernel", "cpu_op"
# every category of work on the card: kernels, copies, fills
DEVICE_CATS = (DEVICE, "gpu_memcpy", "gpu_memset")


def _classify(name: str) -> str:
    """A trace event's family: a port kernel's name, "gemm", "conv",
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


def _trace_file(path: str) -> str:
    if os.path.isfile(path):
        return path
    files = sorted(glob.glob(os.path.join(path, "*.json")))
    if not files:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {path}")
    return files[-1]


def analyze_trace(trace_dir: str, category: str = DEVICE) -> Dict:
    """-> {'total_ms', 'n_events', 'category', 'ops': [(ms, pct, count,
    family), ...]} over the complete events of `category` ("kernel": the
    card's kernels; "cpu_op": the host's operators, whose times nest)."""
    with open(_trace_file(trace_dir)) as f:
        events = json.load(f)["traceEvents"]
    total = defaultdict(lambda: [0.0, 0])
    n = 0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != category:
            continue
        key = _classify(ev.get("name", "?"))
        total[key][0] += float(ev.get("dur", 0.0))
        total[key][1] += 1
        n += 1
    if not n:
        raise ValueError(f"no {category!r} events in the trace (a "
                         "trace of the CPU holds no card kernels)")
    ssum = sum(v[0] for v in total.values()) or 1.0
    ops = sorted(((us / 1e3, 100.0 * us / ssum, cnt, key)
                  for key, (us, cnt) in total.items()), reverse=True)
    return {"total_ms": ssum / 1e3, "n_events": n, "category": category,
            "ops": ops}


def profile_events(prof) -> List[Dict]:
    """The Chrome trace events of a finished `torch.profiler.profile`,
    through a temporary file removed at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def union(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Merged, sorted, disjoint intervals covering the same points."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_share(events: Sequence[Dict], window_us: float) -> float:
    """1 - (the union of the device's kernel, copy and fill intervals among
    a Chrome trace's `events`) / `window_us`, the traced window's wall
    time in microseconds: the share of the window the card waits."""
    busy = union([(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
                  for ev in events if ev.get("ph") == "X"
                  and ev.get("cat") in DEVICE_CATS])
    return 1.0 - sum(e - s for s, e in busy) / window_us


def format_report(report: Dict, top: int = 20) -> str:
    lines = [f"{report['category']}: {report['total_ms']:.3f} ms over "
             f"{report['n_events']} events"]
    lines.append(f"{'ms':>9} {'%':>6} {'count':>7}  family")
    for ms, pct, cnt, key in report["ops"][:top]:
        lines.append(f"{ms:9.3f} {pct:6.1f} {cnt:7d}  {key}")
    return "\n".join(lines)
