"""Sliding-window inference benchmark on one NVIDIA card: exact vs fast
(trunk-once) paths (scripts/bench_infer.py).

    python -m seld_tpu_torch.bench_infer [--clips 8] [--reps 5]
        [--batch 512] [--dtypes fp32,bf16] [--paths exact,fast]
        [--clip_batch 4]

Scores seeded 60-s clips ([3000, 64, 7], 541 windows of 300 frames at step
5) with SS5 at full width and seeded weights, already on the card, through
`ensemble_outputs`: the exact path in chunks of --batch windows, the fast
path clip at a time and, with --clip_batch N > 1, N clips stacked a head
chunk. Each (dtype, path) runs once to warm up (kernel builds, cuDNN plans),
then --reps passes over the clips between two CUDA events: ms per clip is
the elapsed time over reps x clips. One more pass runs under
`torch.profiler`: the summed device time of its kernels per clip, by group
(gru_scan, convolutions, GEMMs, everything else, as profile_step groups
them; the eight largest kernels), and the idle share, 1 - device ms / ms per clip: the share of a
clip the card waits on the host. bf16 casts every float entry of the model
and the clips. Prints a line a measurement, then ONE JSON line with every
measurement, the gru_scan launches per clip, the card's name and power
limit. Without a CUDA card it exits non-zero.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

CLIP_FRAMES = 3000
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--dtypes", default="fp32,bf16")
    ap.add_argument("--paths", default="exact,fast")
    ap.add_argument("--model_config", default="SS5")
    ap.add_argument("--clip_batch", type=int, default=4,
                    help="fast path: also time N clips stacked a head chunk")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_infer: no CUDA device (it measures the card "
                         "and never falls back to the CPU)")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from seld_tpu_torch.bench import card_name_and_power_limit
    from seld_tpu_torch.config import get_model_config
    from seld_tpu_torch.inference.ensemble import ensemble_outputs
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops import kernels
    from seld_tpu_torch.profile_step import _device_us, _group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_model_config(args.model_config, search_paths=["./model_config"])
    cfg["n_classes"] = 12
    time_down = cfg.get("first_pool_size", [5, 1])[0]
    rng = np.random.RandomState(0)
    clips32 = [torch.from_numpy(rng.randn(CLIP_FRAMES, 64, 7).astype(
        np.float32)).cuda() for _ in range(args.clips)]

    runs = []
    for path in args.paths.split(","):
        path = path.strip()
        if path not in ("exact", "fast"):
            raise SystemExit(f"bench_infer: unknown path {path!r}")
        runs.append((path, 1))
        if path == "fast" and args.clip_batch > 1:
            runs.append((path, args.clip_batch))

    results = []
    for dtype in args.dtypes.split(","):
        dt = DTYPES[dtype.strip()]
        model = build_model("conv_temporal", (300, 64, 7), cfg, seed=0,
                            device="cuda").to(dt)
        clips = [c.to(dt) for c in clips32]
        for path, clip_batch in runs:
            def run():
                return ensemble_outputs(
                    model, clips, win_size=300, step_size=5,
                    batch_size=args.batch, fast=path == "fast",
                    time_down=time_down, clip_batch=clip_batch)

            kernels.launch_counts.clear()
            outs = run()
            torch.cuda.synchronize()
            launches = kernels.launch_counts["gru_scan"] / args.clips
            if not all(torch.isfinite(s).all() and torch.isfinite(d).all()
                       for s, d in outs):
                raise SystemExit(f"bench_infer: non-finite outputs "
                                 f"({dtype}, {path})")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                run()
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop) / (args.reps * args.clips)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            per_kernel = {}
            for avg in prof.key_averages():
                if avg.device_type == DeviceType.CUDA:
                    per_kernel[avg.key] = per_kernel.get(avg.key, 0.0) + \
                        _device_us(avg) / 1e3 / args.clips
            groups = {}
            for name, kernel_ms in per_kernel.items():
                groups[_group(name)] = groups.get(_group(name), 0.0) + \
                    kernel_ms
            device_ms = sum(groups.values())
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
            label = path if clip_batch == 1 else f"{path}_cb{clip_batch}"
            print(f"{label:10s} {dtype}: {ms:8.3f} ms/clip "
                  f"({60000.0 / ms:.0f}x real-time) [{args.clips}x"
                  f"{args.reps} clips, batch {args.batch}, gru_scan "
                  f"launches/clip {launches:g}]; device {device_ms:.3f} "
                  f"ms/clip, idle {1 - device_ms / ms:.1%}", flush=True)
            results.append({"path": path, "clip_batch": clip_batch,
                            "dtype": dtype, "ms_per_clip": ms,
                            "device_ms_per_clip": device_ms,
                            "idle_share": 1 - device_ms / ms,
                            "device_ms_by_group": groups,
                            "top": [{"kernel": k[:120], "ms_per_clip": v}
                                    for k, v in top],
                            "gru_scan_launches_per_clip": launches})
    print(json.dumps({
        "metric": "ss5_ms_per_60s_clip", "results": results,
        "clips": args.clips, "reps": args.reps, "batch": args.batch,
        "clip_frames": CLIP_FRAMES,
        "device": torch.cuda.get_device_name(0),
        "card": card_name_and_power_limit()}))


if __name__ == "__main__":
    main()
