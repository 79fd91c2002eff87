"""Streaming-inference latency demo: a simulated live SELD feed
(scripts/stream_demo.py).

    python -m seld_tpu_torch.stream_demo [--model_config SS5] [--chunk 10]
        [--seconds 60] [--reps 3] [--streams 4] [--bf16]
        [--export_dir <bundle>] [--device cuda]

Feeds a seeded clip through `StreamingSELD` in real-time-sized chunks
(--chunk label frames = chunk * time_down feature frames a push) and
reports the per-push latency on the host clock (the serving metric: each
push returns its final frames on the host), the finalize and the
real-time factor. On the card it also reports, for the steady-state
pushes (every push after the one that bootstraps), the span of a push on
the card between two CUDA events, and from one more rep under
`torch.profiler` the summed device time of a push's kernels and the idle
share, 1 - device ms / push ms: the share of a push the card waits on the
host. The last line is one JSON object with every number and the card's
name and power limit. SS5 runs at full width with seeded weights, f32
with TF32 off (or bf16 with --bf16); --export_dir serves an exported
bundle instead (no weights seeded; the geometry comes from its meta.json).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def stream_clip(sp, clip: np.ndarray):
    """One clip through the engine: (emitted frames, host ms a push,
    CUDA-event ms a push or None on the CPU, finalize ms, wall s)."""
    cuda = sp.device.type == "cuda"
    sp.reset()
    lat, spans, emitted = [], [], 0
    t_run0 = time.perf_counter()
    for lo in range(0, clip.shape[-3], sp.chunk_f):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        emitted += len(sp.push(clip[..., lo:lo + sp.chunk_f, :, :]))
        lat.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            stop.record()
            spans.append((start, stop))
    t0 = time.perf_counter()
    emitted += len(sp.finalize())
    fin = (time.perf_counter() - t0) * 1e3
    wall = time.perf_counter() - t_run0
    if cuda:
        torch.cuda.synchronize()
        spans = [a.elapsed_time(b) for a, b in spans]
    return emitted, lat, spans or None, fin, wall


def boot_pushes(sp) -> int:
    """Pushes of chunk_f frames up to and including the one that
    bootstraps (the steady-state pushes come after)."""
    return -(-sp.l_f // sp.chunk_f)


def profile_push_ms(sp, clip: np.ndarray) -> float:
    """The summed device time of one steady-state push's kernels, from a
    torch.profiler trace of every steady-state push of the clip."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from seld_tpu_torch.profile_step import _device_us

    sp.reset()
    n_boot = boot_pushes(sp)
    starts = list(range(0, clip.shape[-3], sp.chunk_f))
    for lo in starts[:n_boot]:
        sp.push(clip[..., lo:lo + sp.chunk_f, :, :])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for lo in starts[n_boot:]:
            sp.push(clip[..., lo:lo + sp.chunk_f, :, :])
        torch.cuda.synchronize()
    sp.finalize()
    device_us = sum(_device_us(a) for a in prof.key_averages()
                    if a.device_type == DeviceType.CUDA)
    return device_us / 1e3 / max(1, len(starts) - n_boot)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="conv_temporal")
    ap.add_argument("--model_config", default="SS5")
    ap.add_argument("--chunk", type=int, default=10,
                    help="label frames per push (10 = 1 s)")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--n_classes", type=int, default=12)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--streams", type=int, default=1,
                    help="lockstep concurrent streams per device step")
    ap.add_argument("--export_dir", default="",
                    help="serve from an exported stream bundle "
                         "(inference.export_model --unit stream) instead "
                         "of seeded weights; geometry flags come from the "
                         "bundle's meta.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.inference.streaming import StreamingSELD
    from seld_tpu_torch.make_answer import require_device

    require_device(args.device, "seld_tpu_torch.stream_demo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.export_dir:
        sp = StreamingSELD.from_exported(args.export_dir, device=args.device)
        if sp.n_streams != args.streams or sp.chunk_t != args.chunk:
            raise SystemExit(
                f"bundle was exported for n_streams={sp.n_streams}, "
                f"chunk={sp.chunk_t}; pass matching --streams/--chunk "
                "or re-export")
    else:
        from seld_tpu_torch.config import get_model_config
        from seld_tpu_torch.models import build_model
        cfg = get_model_config(args.model_config,
                               search_paths=["./model_config"])
        cfg["n_classes"] = args.n_classes
        model = build_model(args.model, (300, 64, 7), cfg, seed=0,
                            device=args.device)
        dtype = None
        if args.bf16:
            model, dtype = model.to(torch.bfloat16), torch.bfloat16
        sp = StreamingSELD(model, feat_shape=(64, 7), chunk=args.chunk,
                           dtype=dtype, n_streams=args.streams)
    print(f"measured trunk halo: {sp.halo_t} frames; "
          f"bootstrap length: {sp.l_f} feature frames "
          f"({sp.l_f / 50:.1f} s); emission latency: "
          f"{(sp.twin + sp.chunk_t) / 10:.1f} s behind the live edge; "
          f"{args.streams} lockstep stream(s) per device step on "
          f"{sp.device}", flush=True)

    # geometry from the engine, so exported bundles of any feature shape
    # or time stride drive the same loop
    t_l = int(args.seconds * 10)          # label frames (100 ms each)
    t_f = t_l * sp.time_down
    clip = np.random.RandomState(0).randn(
        args.streams, t_f, *sp.feat_shape).astype(np.float32)
    if args.streams == 1:
        clip = clip[0]
    n_boot = boot_pushes(sp)
    reps = []
    for rep in range(args.reps):
        emitted, lat, spans, fin, wall = stream_clip(sp, clip)
        steady = np.asarray(lat[n_boot:] if len(lat) > n_boot else lat)
        rtx = args.seconds / wall * args.streams
        line = (f"rep {rep}: {emitted}/{t_l} frames | push p50 "
                f"{np.percentile(steady, 50):.2f} ms  p90 "
                f"{np.percentile(steady, 90):.2f} ms  p99 "
                f"{np.percentile(steady, 99):.2f} ms  max "
                f"{steady.max():.2f} ms | finalize {fin:.2f} ms | whole "
                f"clip {wall:.3f} s = {rtx:.0f}x real-time aggregate")
        rec = {"frames": emitted, "push_p50_ms": np.percentile(steady, 50),
               "push_p90_ms": np.percentile(steady, 90),
               "push_p99_ms": np.percentile(steady, 99),
               "push_max_ms": float(steady.max()),
               "boot_push_ms": lat[n_boot - 1] if len(lat) >= n_boot
               else None,
               "finalize_ms": fin, "wall_s": wall, "realtime_x": rtx}
        if spans is not None:
            ev = np.asarray(spans[n_boot:] if len(spans) > n_boot
                            else spans)
            rec["push_event_p50_ms"] = np.percentile(ev, 50)
            line += (f" | CUDA-event span a push p50 "
                     f"{rec['push_event_p50_ms']:.2f} ms")
        print(line, flush=True)
        reps.append(rec)
        if emitted != t_l:
            raise SystemExit(f"emitted {emitted} of {t_l} frames")

    out = {"halo": sp.halo_t, "l_f": sp.l_f, "chunk": sp.chunk_t,
           "streams": args.streams, "seconds": args.seconds,
           "dtype": "bf16" if args.bf16 else "fp32", "reps": reps,
           "device": str(sp.device)}
    if sp.device.type == "cuda":
        from seld_tpu_torch.bench import card_name_and_power_limit
        device_ms = profile_push_ms(sp, clip)
        push_ms = float(np.mean([r["push_p50_ms"] for r in reps]))
        out.update(device_ms_per_push=device_ms,
                   idle_share=1 - device_ms / push_ms,
                   card=card_name_and_power_limit())
        print(f"device time a steady-state push (torch.profiler): "
              f"{device_ms:.3f} ms of {push_ms:.3f} ms p50 on the host "
              f"clock: idle {1 - device_ms / push_ms:.1%} on "
              f"{out['card']}", flush=True)
    else:
        print("device time a push: not measured (no card)", flush=True)
    print(json.dumps(out, default=float))


if __name__ == "__main__":
    main()
