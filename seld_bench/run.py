"""Run one cell of the benchmark on the card it is started on.

    python3 -m seld_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (build, seeded weights and inputs, the checked first steps, every
shape of the window warmed), then the window: items back to back for
`--seconds`, each ending on the host. `--trace 0` reports the cell's
end-to-end metrics; `--trace 1` runs the window, then traces `trace_items`
more items under torch.profiler and reports the per-layer metrics whose
readers (`metrics/<name>.py`) find something to read. Then the program is
freed and its outputs are judged against the plain reference. The last
lines of standard error are the readings beside their limits; the last
line of standard output is one JSON object.

Exits non-zero, with no result, without a CUDA card or with fewer than
the cell asks for, or if the process holds jax, jaxlib, flax or seld_tpu
once the window has closed.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# compile caches at fixed paths inside the checkout (the port's kernels
# build into <checkout>/build/kernels themselves)
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "seld_tpu")
WINDOW_SPAN = "seld_bench.traced_window"


def forbidden_modules():
    """Top-level names in sys.modules that the run must not hold, compared
    whole (seld_tpu_torch is not seld_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def built_kernels() -> set:
    """The kernel libraries the checkout holds."""
    from seld_tpu_torch.ops import kernels
    return {s for s in kernels.SOURCES
            if os.path.exists(kernels.library_path(s))}


def end_to_end(cell, spec_metrics, elapsed, units, setup_s):
    """The cell's end-to-end metrics: set-up here, the rest its driver's
    (`Cell.end_to_end`)."""
    values = dict(cell.end_to_end(elapsed, units), setup_s=setup_s)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec_metrics if m["name"] in values}


def cell_metrics(bench, name, key):
    """The metrics of `key` ("end_to_end" or "per_layer") this cell
    reports."""
    reported = {m["name"] for m in bench["end_to_end"]
                if name in m.get("workloads", [name])}
    out = []
    for m in bench[key]:
        cells = m.get("workloads")
        if cells is not None:
            if name in cells:
                out.append(m)
        elif key == "end_to_end" or m["moves"] in reported:
            out.append(m)
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from seld_bench import harness
    wl = harness.workload(args.workload)
    chips = wl.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"seld_bench: the cell needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    before = built_kernels()
    result = execute(wl, args, torch.device("cuda", 0))
    if result is None:
        return 3
    # this run built kernels: its set-up took in their compilation
    result["first_build"] = built_kernels() != before
    result["checks"] = result.pop("checks")     # the last key
    print(json.dumps(result))
    return 0


def execute(wl, args, device):
    """Set-up, window, optional trace and check of workload `wl` on
    `device`: the result's dict (readings under "checks"), or None where
    the process holds a forbidden module. Prints the readings on stderr."""
    import gc

    import torch

    from seld_bench import harness
    cuda = device.type == "cuda"
    bench = harness.benchmark()
    name = wl.spec["name"]
    cell = harness.driver(wl.traffic["driver"]).Cell(
        wl.config, wl.traffic, args.seed, device)
    t_imported = time.perf_counter() - _T0
    cell.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _T0
    print(f"setup_s {setup_s!r}: {t_imported!r} to the cell's set-up, "
          + ", ".join(f"{k} {v!r}" for k, v in cell.phases.items()),
          file=sys.stderr)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    attempted = units = 0
    t0 = time.perf_counter()
    while True:
        units += cell.item()
        attempted += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= args.seconds:
            break
    info = {}
    if args.trace:
        metrics, info = traced(cell, bench, name, units / elapsed)
    else:
        metrics = end_to_end(cell, cell_metrics(bench, name, "end_to_end"),
                             elapsed, units, setup_s)
    peak = torch.cuda.max_memory_reserved(device) if cuda else 0
    cell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = harness.readings_with_limits(cell.check(), wl.limits)
    print(f"check_s {time.perf_counter() - t_check!r}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"seld_bench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return None
    result = {"correct": all(r.ok for r in readings),
              "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if cuda else device.type,
                         "count": wl.spec["chips"],
                         "memory_peak_bytes": int(peak),
                         **info.get("device", {})}}
    if "breakdown" in info:
        result["breakdown"] = info["breakdown"]
    result["checks"] = {r.name: {"value": r.value, "limit": r.limit}
                        for r in readings}
    for r in readings:
        print(f"check {r.name} {r.value!r} limit {r.limit!r} "
              f"{'ok' if r.ok else 'FAILED'}", file=sys.stderr)
    return result


def traced(cell, bench, name, unit_rate):
    """Trace `trace_items` items; the per-layer metrics read from it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from seld_bench import harness
    from seld_bench.yardstick.trace import DeviceTrace
    n = cell.traffic["trace_items"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            units = sum(cell.item(record=False) for _ in range(n))
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    trace = DeviceTrace.from_profile(prof, WINDOW_SPAN)
    ctx = {"trace": trace, "items": n, "units": units,
           "unit_rate": unit_rate, "facts": cell.facts()}
    metrics = {}
    for m in cell_metrics(bench, name, "per_layer"):
        value = harness.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy = trace.busy_s()
    return metrics, {"device": {"busy_s": busy, "window_s": trace.window_s},
                     "breakdown": {"device_ops": trace.top_ops(),
                                   "idle_gaps": trace.idle_gaps()}}


if __name__ == "__main__":
    sys.exit(main())
