"""Offline feature extraction (scripts/extract_features.py; the reference's
feature_extractor.py __main__).

Writes the offline `.npy` layout of the reference's data: one feature file
[3000, 64, C] a clip (C = 7 for --mode foa, 10 for mic) and, with
--label_dir, one label file [600, 4 x n_classes] a clip, which
`make_answer` and `search_best` read (`--data`):

    python -m seld_tpu_torch.extract_features --mode foa \\
        --wav_dir <.../foa_dev> --label_dir <.../metadata_dev> \\
        --out_dir foa_dev --label_out_dir foa_dev_label [--normalize]

Clips go through the front-end on the card (`ops.features.
extract_features_clips`) a chunk of up to 8 clips of one length and
sample rate at a time: in mode foa one launch of the foa_frontend kernel a
chunk. --normalize also writes the dataset's per-(frequency, channel)
mean.npy and std.npy in the working directory and the normalised features
in <out_dir>_norm. Runs on the card (--device cuda, the default) unless
--device cpu; without a card it exits non-zero. The training CLI can
also read the wavs directly (`--from_wav`).
"""
from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

CHUNK = 8     # clips a front-end launch


def _chunks(wavs, labels):
    """Runs of up to CHUNK (wav, label) path pairs whose wavs share a sample
    rate, each with their read wavs and the rate."""
    from seld_tpu_torch.data.loader import read_wav
    run, rate = [], None
    for wav_path, label_path in zip(wavs, labels):
        wav, sr = read_wav(wav_path)
        if run and (sr != rate or len(run) == CHUNK):
            yield run, rate
            run = []
        run.append((wav_path, label_path, wav))
        rate = sr
    if run:
        yield run, rate


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", default="foa", choices=["foa", "mic"])
    ap.add_argument("--wav_dir", required=True)
    ap.add_argument("--label_dir", default=None)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--label_out_dir", default=None)
    ap.add_argument("--n_classes", type=int, default=14)
    ap.add_argument("--normalize", action="store_true",
                    help="also write <out_dir>_norm with dataset mean/std")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from seld_tpu_torch.make_answer import require_device
    require_device(args.device, "seld_tpu_torch.extract_features")

    from seld_tpu_torch.ops.features import (apply_normalizer,
                                             calculate_statistics,
                                             extract_features_clips,
                                             extract_labels,
                                             preprocess_features_labels)

    wavs = sorted(glob(os.path.join(args.wav_dir, "*.wav")))
    if args.label_dir:
        # pair by basename, not by sorted position: a count check alone
        # would misalign features and labels when the file sets differ
        labels = []
        for w in wavs:
            name = os.path.splitext(os.path.basename(w))[0]
            csv = os.path.join(args.label_dir, name + ".csv")
            if not os.path.exists(csv):
                raise ValueError(f"no label CSV for {name} in "
                                 f"{args.label_dir}")
            labels.append(csv)
    else:
        labels = [None] * len(wavs)

    label_dir = args.label_out_dir or args.out_dir + "_label"
    os.makedirs(args.out_dir, exist_ok=True)
    if args.label_dir:
        os.makedirs(label_dir, exist_ok=True)

    for run, sr in _chunks(wavs, labels):
        feats = extract_features_clips(
            [w for _, _, w in run], chunk_size=CHUNK, device=args.device,
            sample_rate=sr, mode=args.mode, n_fft=1024, win_length=960,
            hop_length=480)
        for (wav_path, label_path, _), f in zip(run, feats):
            name = os.path.splitext(os.path.basename(wav_path))[0]
            if label_path is not None:
                labs = extract_labels(label_path, n_classes=args.n_classes)
                f, labs = preprocess_features_labels(f, labs)
                np.save(os.path.join(label_dir, name + ".npy"), labs)
            else:
                f, _ = preprocess_features_labels(
                    f, np.zeros((600, 4 * args.n_classes), np.float32))
            np.save(os.path.join(args.out_dir, name + ".npy"), f)
            print(name, f.shape)

    if args.normalize:
        files = sorted(glob(os.path.join(args.out_dir, "*.npy")))
        stacked = np.concatenate([np.load(f) for f in files], 0)
        mean, std = calculate_statistics(stacked)
        np.save("mean.npy", mean)
        np.save("std.npy", std)
        norm_dir = args.out_dir + "_norm"
        os.makedirs(norm_dir, exist_ok=True)
        for f in files:
            np.save(os.path.join(norm_dir, os.path.basename(f)),
                    apply_normalizer(np.load(f), mean, std))
        print(f"normalized features -> {norm_dir}")


if __name__ == "__main__":
    main()
