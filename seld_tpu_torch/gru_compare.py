"""The GRU kernels of two checkouts of this repository timed in turns on
one card.

    python -m seld_tpu_torch.gru_compare OLD_ROOT [NEW_ROOT]
                                          [--units 128 256 384 512 1024]

Times gru_scan and gru_scan_bwd through each checkout's own entry points
(`seld_tpu_torch.ops.gru`, default plans) at D=2, T=60, B=256: U in {128,
256, 384, 512, 1024} in bf16 storage with Rk in bf16 (as the training step
hands it over) and in f32, and U in {384, 512, 1024} in f32 storage. Both
packages are named seld_tpu_torch, so each checkout runs in a process of
its own (`python -P`, the checkout first on PYTHONPATH), which builds its
kernels into its own build/ directory; the processes run old, new, new,
old. Each holds its outputs against its plain versions (GRU_TOL,
BWD_TOL), times each call with CUDA events and splits the backward by
kernel with torch.profiler. NEW_ROOT defaults to this
checkout. Prints one [compare] line a row and checkout, then one JSON
object; exits non-zero without a card or when a checkout disagrees.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

GRU_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
ROWS = tuple((dtype, u, rk) for u in (128, 256, 384, 512, 1024)
             for dtype, rk in (("bfloat16", "bfloat16"),
                               ("bfloat16", "float32"),
                               ("float32", "float32"))
             if dtype == "bfloat16" or u >= 384)
D, T, B = 2, 60, 256


def _ms(fn, iters):
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _split(fn, n=3):
    """Device ms a call by gru_bwd_* kernel (torch.profiler)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for avg in prof.key_averages():
        m = re.search(r"\b(gru_bwd_\w*)", avg.key)
        if avg.device_type != DeviceType.CUDA or not m:
            continue
        us = getattr(avg, "self_device_time_total", None)
        us = avg.self_cuda_time_total if us is None else us
        out[m.group(1)] = out.get(m.group(1), 0.0) + us / 1e3 / n
    return out


def _rel(a, w):
    w = w.float()
    return ((a.float() - w).abs().max() / w.abs().max().clamp_min(1e-30)
            ).item()


def worker(out_path, units):
    """One checkout's rows at `units` (the package on sys.path is the
    checkout's)."""
    import numpy as np
    import torch

    import seld_tpu_torch
    from seld_tpu_torch.ops import gru
    rows = {"package": os.path.dirname(seld_tpu_torch.__file__)}
    for dtype, u, rk_dtype in (r for r in ROWS if r[1] in units):
        rng = np.random.RandomState(u)
        dt = getattr(torch, dtype)
        xp = torch.from_numpy(rng.randn(D, T, B, 3 * u).astype(
            np.float32)).cuda().to(dt)
        rk = torch.from_numpy((rng.randn(D, u, 3 * u) / math.sqrt(u))
                              .astype(np.float32)).cuda().to(
                                  getattr(torch, rk_dtype))
        rb = torch.from_numpy(0.1 * rng.randn(D, 3 * u).astype(
            np.float32)).cuda()
        g = torch.from_numpy(rng.randn(D, T, B, u).astype(
            np.float32)).cuda().to(dt)
        with torch.no_grad():
            ref = gru.gru_scan_ref(xp, rk, rb)
            hs = gru.gru_scan(xp, rk, rb)
            got = gru.gru_scan_bwd(xp, rk, rb, ref, g)
            want = gru.gru_scan_bwd_ref(xp, rk, rb, ref, g)
            err = (hs.float() - ref.float()).abs().max().item()
            tols = [BWD_TOL[dtype], BWD_TOL[str(rk.dtype)[6:]],
                    BWD_TOL["float32"]]
            errs = [_rel(a, w) for a, w in zip(got, want)]
            iters = 3 if u >= 1024 else 10
            row = {"fwd_ms": _ms(lambda: gru.gru_scan(xp, rk, rb), iters),
                   "bwd_ms": _ms(lambda: gru.gru_scan_bwd(xp, rk, rb, ref,
                                                          g), iters),
                   "bwd_split_ms": _split(lambda: gru.gru_scan_bwd(
                       xp, rk, rb, ref, g)),
                   "fwd_max_abs_err": err, "bwd_rel_err": errs,
                   "ok": err <= GRU_TOL[dtype] and all(
                       e <= tl for e, tl in zip(errs, tols))}
        rows[f"{dtype}_U{u}_Rk_{rk_dtype}"] = row
        del xp, rk, g, ref, hs, got, want
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(rows, f)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("old_root")
    parser.add_argument("new_root", nargs="?", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--units", type=int, nargs="+",
                        default=[128, 256, 384, 512, 1024])
    parser.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.units)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gru_compare: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[compare] {smi}", flush=True)
    roots = {"old": os.path.abspath(args.old_root),
             "new": os.path.abspath(args.new_root)}
    result = {"device": smi, "roots": roots, "old": {}, "new": {}}
    for i, name in enumerate(["old", "new", "new", "old"]):
        out = os.path.join(roots["new"], "build", f"compare_{i}.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        env = dict(os.environ, PYTHONPATH=roots[name])
        subprocess.run([sys.executable, "-P", os.path.abspath(__file__),
                        args.old_root, "--worker", out, "--units",
                        *map(str, args.units)], cwd=roots[name],
                       env=env, check=True, timeout=1800)
        with open(out) as f:
            rows = json.load(f)
        if os.path.realpath(rows.pop("package")) != os.path.realpath(
                os.path.join(roots[name], "seld_tpu_torch")):
            raise SystemExit(f"the {name} run imported another package")
        for key, row in rows.items():
            print(f"[compare] {name} {key}: forward {row['fwd_ms']:.4f} ms "
                  f"(max_abs_err {row['fwd_max_abs_err']:.2e}), backward "
                  f"{row['bwd_ms']:.4f} ms (" + ", ".join(
                      f"{k} {v:.4f}" for k, v in row["bwd_split_ms"].items())
                  + ", rel_err " + "/".join(
                      f"{e:.1e}" for e in row["bwd_rel_err"]) + ") "
                  + ("ok" if row["ok"] else "FAIL"), flush=True)
            if not row["ok"]:
                raise SystemExit(f"the {name} kernels disagree at {key}")
            result[name].setdefault(key, []).append(row)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
