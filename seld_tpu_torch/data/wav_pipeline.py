"""Wav-native input pipeline: raw clips -> front-end on the card -> windows
(seld_tpu/data/wav_pipeline.py).

wav (int16/int32 PCM) -> features on the card -> pad/crop to the label
geometry -> train-split statistics, applied to every split -> 300/60-frame
windows. The features never touch disk. Three inputs:
  - FOA (mode "foa", foa_dev): 7 channels through the fused front-end
    kernel, a chunk of equal-length clips per launch;
  - microphone array (mode "mic", mic_dev): 10 channels, log-mel and
    GCC-PHAT through the plain composition;
  - joint FOA+MIC (`mic_dir`): 17 channels, the two extractions side by
    side on the channel axis, each normalised by its own train-split
    statistics (equal to statistics over the concatenation, since every
    statistic is per channel).
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from seld_tpu_torch.data.loader import (SPLITS, SeldDataset, _fold_of,
                                        load_wav_clips)
from seld_tpu_torch.ops.features import (apply_normalizer,
                                         calculate_statistics,
                                         extract_features_clips,
                                         preprocess_features_labels)


def _clip_stems(wav_dir: str, mode: str):
    return [os.path.splitext(os.path.basename(p))[0]
            for p in sorted(glob(os.path.join(wav_dir, "*.wav")))
            if _fold_of(p) in SPLITS[mode]]


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


def joint_wav_feature_splits(foa_dir: str,
                             mic_dir: str,
                             label_dir: str,
                             *,
                             modes: Sequence[str] = ("train", "val", "test"),
                             **kwargs) -> Tuple[
                                 Dict[str, Tuple[np.ndarray, np.ndarray]],
                                 Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Joint FOA+MIC 17-channel splits (4 FOA mel + 3 IV + 4 mic mel + 6
    GCC), the layout `acs_aug` takes; FOA's labels. The clips of the two
    directories pair by position, so their stems must be identical split
    by split: a count check alone would misalign every clip after the
    first divergence."""
    for m in modes:
        fs, ms = _clip_stems(foa_dir, m), _clip_stems(mic_dir, m)
        if fs != ms:
            diff = next((a, b) for a, b in zip(fs + [None], ms + [None])
                        if a != b)
            raise ValueError(
                f"{m}: foa_dir and mic_dir clip sets diverge at "
                f"{diff[0]!r} vs {diff[1]!r} — joint extraction pairs "
                f"clips positionally and needs identical recordings")
    foa_splits, foa_stats = wav_feature_splits(
        foa_dir, label_dir, modes=modes, mode="foa", **kwargs)
    mic_splits, mic_stats = wav_feature_splits(
        mic_dir, label_dir, modes=modes, mode="mic", **kwargs)
    splits = {m: (np.concatenate([foa_splits[m][0], mic_splits[m][0]],
                                 axis=-1), foa_splits[m][1])
              for m in modes}
    stats = None
    if foa_stats is not None and mic_stats is not None:
        stats = tuple(np.concatenate([f, m], axis=-1)
                      for f, m in zip(foa_stats, mic_stats))
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
    train-split statistics must be kept with the run (normalizer.npz).

    `mode="mic"` extracts the 10-channel GCC-PHAT stack from `wav_dir`;
    `mic_dir` builds the joint 17-channel set (wav_dir = foa_dev, mic_dir
    = mic_dev), and `mode` is then ignored."""
    if mic_dir is not None:
        kwargs.pop("mode", None)
        splits, stats = joint_wav_feature_splits(
            wav_dir, mic_dir, label_dir, n_classes=n_classes, **kwargs)
    else:
        splits, stats = wav_feature_splits(wav_dir, label_dir,
                                           n_classes=n_classes, **kwargs)
    datasets = {
        m: SeldDataset.from_clips(list(x), list(y), batch_size=batch,
                                  train=m == "train", loop_time=loop_time,
                                  feature_dtype=feature_dtype)
        for m, (x, y) in splits.items()
    }
    return datasets, splits, stats
