"""One-command VAD vertical rehearsal (scripts/vad_rehearsal.py).

Drives the whole VAD chain (reference workflow: vad_dataloader.py __main__
featurization -> train_vad_baseline.py:38-73 training -> :206-227 AUC/F1
reporting):

1. synthesize a TIMIT-like mono VAD corpus — "speech" is AM-modulated
   band-limited noise bursts over a quiet noise floor, with sample-level
   0/1 labels, written as real PCM wavs + .npy labels (the JAX package's
   synthesizer, the same draws for a seed);
2. featurize through `python -m seld_tpu_torch.prepare_vad` (80-mel log
   spectrograms, min-max normalized — vad_dataloader.py:77-98);
3. train the bDNN baseline through `python -m seld_tpu_torch.train_vad`
   (7-frame context windows, AdaBelief, AUC early stop);
4. print the window AUC and full-sequence metrics, and last one JSON line
   {"best_val_auc", "sequence", "seconds"}.

    python -m seld_tpu_torch.vad_rehearsal --workdir /tmp/vad_rehearsal \\
        [--clips 96] [--val_clips 24] [--epochs 24] [--device cuda|cpu]

The two CLIs run in this process (their `main`), on --device: the card
unless --device cpu. The train npz it leaves behind is the `--vad_pairs`
input of `python -m seld_tpu_torch.nas_search --task vad`.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import wave

import numpy as np


def _bandpass_noise(rng, n, sr, lo=300.0, hi=3000.0):
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    spec[(freqs < lo) | (freqs > hi)] = 0.0
    out = np.fft.irfft(spec, n)
    return out / (np.std(out) + 1e-8)


def synthesize_clip(rng, seconds, sr):
    """One mono clip + sample-level labels: 2-6 'speech' bursts."""
    n = int(seconds * sr)
    wav = 0.01 * rng.standard_normal(n)          # noise floor
    label = np.zeros(n, np.float32)
    for _ in range(int(rng.integers(2, 7))):
        dur = int(rng.uniform(0.3, 1.5) * sr)
        start = int(rng.integers(0, max(1, n - dur)))
        burst = _bandpass_noise(rng, dur, sr)
        # syllabic 3-8 Hz amplitude modulation, fade-in/out edges
        t = np.arange(dur) / sr
        am = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3.0, 8.0) * t
                                  + rng.uniform(0, 2 * np.pi))
        edge = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.03)
        wav[start:start + dur] += 0.25 * burst * am * edge
        label[start:start + dur] = 1.0
    peak = np.max(np.abs(wav))
    if peak > 0.99:
        wav *= 0.99 / peak
    return wav.astype(np.float32), label


def write_wav(path, wav, sr):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())


def synthesize_split(root, n_clips, seconds, sr, seed):
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(root, "wav")
    label_dir = os.path.join(root, "label")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)
    for i in range(n_clips):
        wav, label = synthesize_clip(rng, seconds, sr)
        write_wav(os.path.join(wav_dir, f"clip{i:04d}.wav"), wav, sr)
        np.save(os.path.join(label_dir, f"clip{i:04d}.npy"), label)
    return wav_dir, label_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--clips", type=int, default=96)
    ap.add_argument("--val_clips", type=int, default=24)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--units", type=int, default=512)
    ap.add_argument("--model", default="vad_architecture")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip_synth", action="store_true",
                    help="reuse an existing workdir's wavs and npzs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch import prepare_vad, train_vad
    from seld_tpu_torch.make_answer import require_device
    require_device(args.device, "seld_tpu_torch.vad_rehearsal")

    seconds = {}
    train_npz = os.path.join(args.workdir, "train.npz")
    val_npz = os.path.join(args.workdir, "val.npz")
    if (not args.skip_synth or not os.path.exists(train_npz)
            or not os.path.exists(val_npz)):
        seconds["synthesize"] = seconds["prepare"] = 0.0
        for split, n, seed in (("train", args.clips, args.seed),
                               ("val", args.val_clips, args.seed + 1)):
            t0 = time.perf_counter()
            wav_dir, label_dir = synthesize_split(
                os.path.join(args.workdir, split), n, args.seconds,
                args.sr, seed)
            t1 = time.perf_counter()
            prepare_vad.main(["--wav_dir", wav_dir, "--label_dir", label_dir,
                              "--out", os.path.join(args.workdir,
                                                    f"{split}.npz"),
                              "--device", args.device])
            seconds["synthesize"] += t1 - t0
            seconds["prepare"] += time.perf_counter() - t1
        print(f"synthesized {args.clips}+{args.val_clips} clips")

    t0 = time.perf_counter()
    result = train_vad.main(["--train", train_npz, "--val", val_npz,
                             "--model", args.model,
                             "--epochs", str(args.epochs),
                             "--batch", str(args.batch),
                             "--lr", str(args.lr),
                             "--units", str(args.units),
                             "--device", args.device])
    seconds["train"] = time.perf_counter() - t0
    print(f"VAD rehearsal done; NAS input: --vad_pairs {train_npz}")
    out = {"best_val_auc": result["best_val_auc"],
           "sequence": result["sequence"], "epochs": result["epochs"],
           "seconds": seconds}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
