"""Wav-native input pipeline: raw clips -> front-end on the card -> windows
(seld_tpu/data/wav_pipeline.py).

wav (int16/int32 PCM) -> features through the fused front-end kernel, a
chunk of equal-length clips per launch -> pad/crop to the label geometry ->
train-split statistics, applied to every split -> 300/60-frame windows. The
features never touch disk.

FOA only: the microphone-array features and the joint 17-channel input
(`mode="mic"`, `mic_dir`) are not ported yet (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from seld_tpu_torch.data.loader import SeldDataset, load_wav_clips
from seld_tpu_torch.ops.features import (apply_normalizer,
                                         calculate_statistics,
                                         extract_features_clips,
                                         preprocess_features_labels)

_UNPORTED = ("the microphone-array and joint FOA+MIC inputs are not ported "
             "yet (ROADMAP queue 1, item 8)")


def features_from_wavs(wavs: Sequence[np.ndarray],
                       labels: Sequence[np.ndarray],
                       *,
                       mode: str = "foa",
                       sample_rate: int = 24000,
                       n_fft: int = 1024,
                       win_length: int = 960,
                       hop_length: int = 480,
                       max_label_length: int = 600,
                       multiplier: int = 5,
                       chunk_size: int = 8,
                       device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """[chan, T] wav clips -> (features [N, max*mult, F, C], labels
    [N, max, 4C]): extract at true length on `device`, then zero-pad or
    crop."""
    if mode != "foa":
        raise NotImplementedError(_UNPORTED)
    raw = extract_features_clips(
        wavs, chunk_size=chunk_size, device=device, sample_rate=sample_rate,
        mode=mode, n_fft=n_fft, win_length=win_length, hop_length=hop_length)
    feats, labs = [], []
    for f, lab in zip(raw, labels):
        f, lab = preprocess_features_labels(
            f, np.asarray(lab), max_label_length=max_label_length,
            multiplier=multiplier)
        feats.append(f)
        labs.append(lab)
    return np.stack(feats), np.stack(labs)


def wav_feature_splits(wav_dir: str,
                       label_dir: str,
                       *,
                       modes: Sequence[str] = ("train", "val", "test"),
                       mode: str = "foa",
                       n_classes: int = 12,
                       sample_rate: int = 24000,
                       max_label_length: int = 600,
                       normalize: bool = True,
                       device="cuda",
                       **front_end) -> Tuple[
                           Dict[str, Tuple[np.ndarray, np.ndarray]],
                           Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Fold-split wav loading + extraction on `device` + train-split
    normalization (per-(freq, chan) mean/std over the train split's
    concatenated frames, applied to every split).

    Returns ({split: (features, labels)}, (mean, std) or None).
    """
    splits = {}
    for m in modes:
        wavs, labels = load_wav_clips(wav_dir, label_dir, m,
                                      n_classes=n_classes,
                                      max_label_length=max_label_length,
                                      pcm=True)
        if not wavs:
            raise FileNotFoundError(
                f"no {m} wavs under {wav_dir} (fold-split by filename)")
        splits[m] = features_from_wavs(
            wavs, labels, mode=mode, sample_rate=sample_rate,
            max_label_length=max_label_length, device=device, **front_end)

    stats = None
    if normalize:
        src = splits.get("train") or next(iter(splits.values()))
        stats = calculate_statistics(src[0].reshape(-1, *src[0].shape[2:]))
        splits = {m: (apply_normalizer(x, *stats), y)
                  for m, (x, y) in splits.items()}
    return splits, stats


def make_wav_datasets(wav_dir: str,
                      label_dir: str,
                      *,
                      batch: int,
                      loop_time: int = 5,
                      n_classes: int = 12,
                      mic_dir: Optional[str] = None,
                      feature_dtype=None,
                      **kwargs):
    """({split: SeldDataset}, {split: (full-clip features, labels)},
    (mean, std)): the datasets the training CLI builds from raw wavs. The
    train-split statistics must be kept with the run (normalizer.npz)."""
    if mic_dir is not None or kwargs.get("mode", "foa") != "foa":
        raise NotImplementedError(_UNPORTED)
    splits, stats = wav_feature_splits(wav_dir, label_dir,
                                       n_classes=n_classes, **kwargs)
    datasets = {
        m: SeldDataset.from_clips(list(x), list(y), batch_size=batch,
                                  train=m == "train", loop_time=loop_time,
                                  feature_dtype=feature_dtype)
        for m, (x, y) in splits.items()
    }
    return datasets, splits, stats
