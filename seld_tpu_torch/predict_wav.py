"""End-to-end serving CLI: raw wavs -> the front-end -> sliding-window
inference -> DCASE prediction CSVs (scripts/predict_wav.py).

    python -m seld_tpu_torch.predict_wav --wav_dir <dir with *.wav> \\
        --model_config SS5 --ckpt <checkpoint dir> \\
        --normalizer <normalizer.npz from the --from_wav run> \\
        --output_path ./answer [--fast | --stream] [--thresholds class|0.5]

No offline features anywhere: the deployment twin of `python -m
seld_tpu_torch.train --from_wav`. The checkpoint is one the port's trainer
saved (`bestscore_*`, `SWA_best_*`). Three paths, clip at a time:

  (default)  features of the whole clip, padded or cropped to
             --max_label_frames, then the exact sliding-window path;
  --fast     the same features, the trunk-once fast path;
  --stream   the real-time engine (StreamingSELDWav, 1-s pushes of raw
             samples): clips keep their true length (no padding), and the
             CSVs equal --fast's on clips of that length.

Runs on the card (--device cuda, the default) unless --device cpu; without
a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np


def main(argv=None):
    from seld_tpu_torch.make_answer import require_device

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    require_device(pre.parse_known_args(argv)[0].device,
                   "seld_tpu_torch.predict_wav")

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--wav_dir", required=True)
    ap.add_argument("--model", default="conv_temporal")
    ap.add_argument("--model_config", required=True,
                    help="zoo name or a model-config JSON path")
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint dir saved by the port's trainer")
    ap.add_argument("--normalizer", required=True,
                    help="normalizer.npz (mean/std) saved by the "
                         "--from_wav training run")
    ap.add_argument("--output_path", default="./predict_out")
    ap.add_argument("--n_classes", type=int, default=12)
    ap.add_argument("--win_size", type=int, default=300)
    ap.add_argument("--step_size", type=int, default=5)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--thresholds", default="class")
    ap.add_argument("--max_label_frames", type=int, default=600,
                    help="pad/crop clips to this many 100ms label frames "
                         "(600 = the 60s DCASE geometry)")
    ap.add_argument("--fast", action="store_true",
                    help="trunk-once sliding window (conv_temporal only)")
    ap.add_argument("--stream", action="store_true",
                    help="serve each clip through the real-time streaming "
                         "engine (StreamingSELDWav, 1 s pushes) instead of "
                         "the batch path; clips keep their true length "
                         "(no 600-frame padding)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.config import resolve_model_config
    from seld_tpu_torch.data.loader import read_wav
    from seld_tpu_torch.data.wav_pipeline import features_from_wavs
    from seld_tpu_torch.inference import (DEFAULT_CLASS_THRESHOLDS,
                                          StreamingSELDWav, ensemble_outputs)
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops.features import apply_normalizer
    from seld_tpu_torch.train.checkpoint import load_variables
    from seld_tpu_torch.utils import io

    model_config = resolve_model_config(args.model_config)
    model_config["n_classes"] = args.n_classes
    if (args.fast or args.stream) and args.model != "conv_temporal":
        raise SystemExit("--fast/--stream support conv_temporal only "
                         "(they need the trunk/head stage split)")

    wav_paths = sorted(glob(os.path.join(args.wav_dir, "*.wav")))
    if not wav_paths:
        raise SystemExit(f"no wavs under {args.wav_dir}")

    if args.thresholds == "class":
        if args.n_classes > len(DEFAULT_CLASS_THRESHOLDS):
            raise SystemExit(
                f"--thresholds class provides {len(DEFAULT_CLASS_THRESHOLDS)}"
                f" per-class values; pass a scalar for "
                f"--n_classes {args.n_classes}")
        thresholds = DEFAULT_CLASS_THRESHOLDS[: args.n_classes]
    else:
        thresholds = float(args.thresholds)

    stats = np.load(args.normalizer)
    model = build_model(args.model, (args.win_size, 64, 7), model_config,
                        device=args.device)
    load_variables(os.path.abspath(args.ckpt.rstrip("/")), model)
    time_down = model_config.get("first_pool_size", [5, 1])[0]

    # one clip at a time (read -> featurize -> normalize -> predict ->
    # write): peak memory is one clip whatever the directory's size. The
    # batch paths pad/crop clips to the fixed label length as training does.
    max_label = args.max_label_frames
    dummy_labels = [np.zeros((max_label, 4 * args.n_classes), np.float32)]
    os.makedirs(args.output_path, exist_ok=True)

    streamer = None
    if args.stream:
        if args.step_size != time_down:
            raise SystemExit(
                f"--stream windows at stride time_down ({time_down}); "
                f"--step_size {args.step_size} is not supported in stream "
                "mode (use the batch path for other strides)")
        streamer = StreamingSELDWav(
            model, normalizer=(stats["mean"], stats["std"]),
            win_size=args.win_size, time_down=time_down)

    for p in wav_paths:
        name = os.path.splitext(os.path.basename(p))[0]
        wav, sr = read_wav(p)
        if sr != 24000:
            raise SystemExit(
                f"{name}: {sr} Hz, but the DCASE front-end geometry (hop "
                f"480 samples = 20 ms, 5 feature frames per 100 ms label "
                f"frame) and the checkpoint's normalizer assume 24 kHz — "
                f"resample first")
        if streamer is not None:
            # live-serving twin: 1 s pushes, final frames as they settle
            streamer.reset()
            keep = (wav.shape[1] // 480) * 480
            min_s = args.win_size * 480  # one analysis window of samples
            if keep < min_s:
                raise SystemExit(
                    f"{name}: {wav.shape[1]} samples < one {args.win_size}"
                    f"-frame analysis window ({min_s} samples); --stream "
                    "keeps true clip lengths (no padding) — use the batch "
                    "path for sub-window clips")
            wav = wav[:, :keep]  # crop to a hop multiple BEFORE slicing
            out = []
            for lo in range(0, keep, 24000):
                out.extend(streamer.push(wav[:, lo:lo + 24000]))
            out.extend(streamer.finalize())
            sed = np.stack([s for s, _ in out])
            doa = np.stack([d for _, d in out])
        else:
            feats, _ = features_from_wavs([wav], dummy_labels,
                                          sample_rate=sr,
                                          max_label_length=max_label,
                                          device=args.device)
            feats = apply_normalizer(feats[0], stats["mean"], stats["std"])
            ((sed, doa),) = ensemble_outputs(
                model, [feats.astype(np.float32)], win_size=args.win_size,
                step_size=args.step_size, batch_size=args.batch,
                fast=args.fast, time_down=time_down)
            sed, doa = sed.cpu().numpy(), doa.cpu().numpy()
        io.write_answer(args.output_path, name + ".csv", sed > thresholds,
                        doa)
    print(f"wrote {len(wav_paths)} prediction CSVs to {args.output_path}")


if __name__ == "__main__":
    main()
