"""TDM training pipeline: curriculum + feature re-extraction on the card
(seld_tpu/data/tdm_pipeline.py).

With --use_tdm the train set is rebuilt every `tdm_epoch` epochs: single-
class bank events are pasted into copies of the raw wavs (data/tdm.py, on
the host), the features are extracted again (on the card, one launch of
the front-end kernel per chunk of 8 equal clips), normalised over the
fresh set and windowed. The allowed overlap grows on a curriculum (after
epoch 20, every 2 epochs: overlap_sec 1 -> 3, then overlap_num 1 -> 3).

`make_tdm_trainset` records the seconds of each part of a rebuild in the
`timing` dict it is handed: paste (host), extract (the front-end, card and
copies back), normalize and window (host).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np

from seld_tpu_torch.data.loader import SeldDataset
from seld_tpu_torch.data.tdm import tdm_aug
from seld_tpu_torch.ops.features import extract_features_clips


class TDMCurriculum:
    """Growing-overlap schedule. Reference semantics, reproduced exactly:
    overlap_sec grows 1 -> max, then every time overlap_num is bumped
    overlap_sec resets to 1 and regrows."""

    def __init__(self, max_overlap_num: int = 3, max_overlap_sec: int = 3,
                 warmup_epochs: int = 20, grow_every: int = 2):
        self.overlap_num = 1
        self.overlap_sec = 1
        self.max_overlap_num = max_overlap_num
        self.max_overlap_sec = max_overlap_sec
        self.warmup_epochs = warmup_epochs
        self.grow_every = grow_every

    def advance(self, epoch: int) -> None:
        if epoch % self.grow_every == 0 and epoch > self.warmup_epochs:
            if self.overlap_sec < self.max_overlap_sec:
                self.overlap_sec += 1
            elif self.overlap_num < self.max_overlap_num:
                self.overlap_sec = 1
                self.overlap_num += 1


def extract_clip_features(wavs: Sequence[np.ndarray],
                          sample_rate: int = 24000,
                          mode: str = "foa",
                          max_frames: int = 3000,
                          chunk_size: int = 8,
                          device="cuda") -> np.ndarray:
    """The front-end on `device` over clips -> [N, max_frames, 64, C],
    zero-padded or cropped; one extraction per `chunk_size` equal clips."""
    raw = extract_features_clips(wavs, chunk_size=chunk_size, device=device,
                                 sample_rate=sample_rate, mode=mode,
                                 n_fft=1024, win_length=960, hop_length=480)
    feats = []
    for f in raw:
        if f.shape[0] < max_frames:
            f = np.pad(f, ((0, max_frames - f.shape[0]), (0, 0), (0, 0)))
        feats.append(f[:max_frames])
    return np.stack(feats)


def make_tdm_trainset(wavs: Sequence[np.ndarray],
                      labels: Sequence[np.ndarray],
                      banks: Tuple[Sequence[np.ndarray], Sequence[np.ndarray]],
                      rng: np.random.RandomState,
                      batch_size: int,
                      curriculum: TDMCurriculum,
                      loop_time: int = 1,
                      sample_rate: int = 24000,
                      min_overlap_sec: float = 0.5,
                      max_overlap_per_frame: int = 2,
                      seed: int = 0,
                      device="cuda",
                      timing: Optional[dict] = None) -> SeldDataset:
    """Paste events -> features on `device` -> normalization over the fresh
    set (std floored at 1e-8) -> windows. The features stay f32, as the
    JAX package keeps them."""
    t0 = time.perf_counter()
    tdm_x, tdm_y = banks
    aug_wavs = [w.copy() for w in wavs]
    aug_labels = [lab.copy() for lab in labels]
    aug_wavs, aug_labels = tdm_aug(
        aug_wavs, aug_labels, tdm_x, tdm_y, rng, sr=sample_rate,
        max_overlap_num=curriculum.overlap_num,
        max_overlap_per_frame=max_overlap_per_frame,
        min_overlap_sec=min_overlap_sec,
        max_overlap_sec=curriculum.overlap_sec)
    t1 = time.perf_counter()

    # feature frames = label frames * multiplier (hop 480 at 24 kHz = 5x)
    feats = extract_clip_features(aug_wavs, sample_rate=sample_rate,
                                  max_frames=aug_labels[0].shape[0] * 5,
                                  device=device)
    del aug_wavs
    t2 = time.perf_counter()
    mean = feats.reshape(-1, *feats.shape[2:]).mean(0, keepdims=True)
    std = feats.reshape(-1, *feats.shape[2:]).std(0, keepdims=True)
    feats = (feats - mean[None]) / np.maximum(std[None], 1e-8)

    ds = SeldDataset.from_clips(
        list(feats), list(aug_labels), batch_size=batch_size,
        loop_time=loop_time, seed=seed)
    if timing is not None:
        timing.update(paste_s=t1 - t0, extract_s=t2 - t1,
                      normalize_window_s=time.perf_counter() - t2)
    return ds
