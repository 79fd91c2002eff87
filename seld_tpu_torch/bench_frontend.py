"""Front-end dataset-build benchmark: batched against per-clip extraction
(scripts/bench_frontend.py).

    python -m seld_tpu_torch.bench_frontend [--clips 16] [--chunk 8]
        [--mode foa] [--seconds 60]

Times the extraction of N seeded clips (4 channels, 24 kHz) through the
front-end on the card: `extract_features_clips` a chunk of clips a launch
(int16 PCM and float32 inputs), against a loop of one `extract_features`
call a clip, and extrapolates each to a 500-clip dataset build. Each timed
run ends with its features copied back to the host. Runs on the card
(--device cuda, the default) unless --device cpu; without a card it
exits non-zero.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clips", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--mode", default="foa", choices=["foa", "mic"])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.make_answer import require_device
    require_device(args.device, "seld_tpu_torch.bench_frontend")

    import numpy as np
    import torch

    from seld_tpu_torch.ops.features import (extract_features,
                                             extract_features_clips)

    rng = np.random.RandomState(0)
    pcm = [(rng.randn(4, int(24000 * args.seconds)) * 6000).astype(np.int16)
           for _ in range(args.clips)]
    wavs = [p.astype(np.float32) / 32768.0 for p in pcm]

    def batched(src):
        return extract_features_clips(src, chunk_size=args.chunk,
                                      mode=args.mode, device=args.device)

    def per_clip():
        return [extract_features(torch.from_numpy(w).to(args.device),
                                 mode=args.mode).cpu().numpy()
                for w in wavs]

    # warm-up of every path (the kernels build at first use)
    for src in (wavs, pcm):
        batched(src[:args.chunk])
    extract_features(torch.from_numpy(wavs[0]).to(args.device),
                     mode=args.mode).cpu()

    def timed(fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        return time.perf_counter() - t0

    out = {"batched_pcm_s": timed(batched, pcm),
           "batched_float_s": timed(batched, wavs),
           "per_clip_float_s": timed(per_clip)}
    n = args.clips

    def row(label, t):
        print(f"{label:38s} {t:6.2f}s for {n} clips "
              f"({t / n * 1e3:4.0f} ms/clip; 500 clips ~ {t / n * 500:.0f}s)")

    row(f"batched int16 PCM ({args.mode}, chunk {args.chunk}):",
        out["batched_pcm_s"])
    row(f"batched float32 ({args.mode}, chunk {args.chunk}):",
        out["batched_float_s"])
    row("per-clip float32 loop:", out["per_clip_float_s"])
    print(f"speedup over the per-clip loop: "
          f"{out['per_clip_float_s'] / out['batched_pcm_s']:.1f}x (int16 "
          f"input {out['batched_float_s'] / out['batched_pcm_s']:.2f}x "
          f"over float32)")
    print("device: " + (torch.cuda.get_device_name(0)
                        if torch.device(args.device).type == "cuda"
                        else "cpu (the host's times, not a card's)"))
    return out


if __name__ == "__main__":
    main()
