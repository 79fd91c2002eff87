"""Build a VAD (features, labels) pairs .npz from wav + label directories
(scripts/prepare_vad.py; reference vad_dataloader.py __main__).

    python -m seld_tpu_torch.prepare_vad --wav_dir <.../WAV> \\
        --label_dir <.../LABEL> --out train.npz [--n_mels 80] \\
        [--device cuda|cpu]

Labels are .npy sample-level 0/1 arrays named like the wavs
(vad_dataloader.py:11-16); wavs may live in nested subdirectories and are
read with the port's PCM reader (data/loader.py::read_wav). Features are
computed on --device (the card unless --device cpu) and saved from the
host.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def search_sub_dirs(path, ext="wav"):
    fnames = glob.glob(os.path.join(path, f"*.{ext}"))
    for sd in sorted(os.listdir(path)):
        sub = os.path.join(path, sd)
        if os.path.isdir(sub):
            fnames += search_sub_dirs(sub, ext)
    return fnames


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wav_dir", required=True)
    ap.add_argument("--label_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_fft", type=int, default=1024)
    ap.add_argument("--n_mels", type=int, default=80)
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from seld_tpu_torch.data.loader import read_wav
    from seld_tpu_torch.data.vad import (vad_features_from_wav,
                                         vad_labels_from_samples)
    from seld_tpu_torch.make_answer import require_device
    require_device(args.device, "seld_tpu_torch.prepare_vad")

    wav_fnames = sorted(search_sub_dirs(args.wav_dir))
    pairs = []
    for wav_path in wav_fnames:
        name = os.path.splitext(os.path.basename(wav_path))[0]
        label_path = os.path.join(args.label_dir, name + ".npy")
        if not os.path.exists(label_path):
            print(f"skip (no label): {name}")
            continue
        wav, sr = read_wav(wav_path)
        feat = vad_features_from_wav(
            torch.from_numpy(wav).to(args.device), n_fft=args.n_fft,
            n_mels=args.n_mels, sr=sr).cpu().numpy()
        label = vad_labels_from_samples(np.load(label_path), n_fft=args.n_fft)
        n = min(len(feat), len(label))
        pairs.append((feat[:n], label[:n]))
        print(f"{name}: {feat.shape}")

    arr = np.empty(len(pairs), dtype=object)
    for i, pair in enumerate(pairs):
        arr[i] = pair
    np.savez_compressed(args.out, pairs=arr)
    print(f"{len(pairs)} pairs -> {args.out}")


if __name__ == "__main__":
    main()
