"""TDM (track-density-modulation) augmentation: event-bank pasting.

Host-side numpy port of the reference's TDM machinery:
  - single-class event extraction   single_class.py:26-73 (contiguous
    >=10-frame single-class segments cropped from wav + frame labels)
  - per-class event banks           data_loader.py:171-185 (one concatenated
    (wav, label) bank per class)
  - TDM_aug                         data_loader.py:188-234 (paste up to
    `max_overlap_num` events — classes drawn inversely proportional to bank
    size — into each clip, respecting per-frame polyphony and no-duplicate-
    class constraints)

Operates on raw wavs before feature extraction, so the augmented clips flow
through the same on-device front-end as real data.
"""
from __future__ import annotations

from typing import Optional, Dict, List, Sequence, Tuple

import numpy as np


def extract_single_class_events(wav: np.ndarray, label: np.ndarray,
                                sr: int = 24000, label_resolution: float = 0.1,
                                min_frames: int = 10,
                                n_classes: Optional[int] = None
                                ) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Find contiguous single-class runs of >= min_frames.

    wav [chan, samples], label [frames, 4*n_classes]. n_classes defaults to
    label.shape[1] // 4 — a wrong explicit value would slice DOA columns
    into the SED block and silently mis-class events.
    Returns [(class, wav_crop [chan, s], label_crop [f, 4C]), ...].
    """
    if n_classes is None:
        n_classes = label.shape[1] // 4
    sed = label[:, :n_classes]
    active = sed.sum(axis=1)
    single = active == 1
    cls_per_frame = np.argmax(sed, axis=1)
    spf = int(sr * label_resolution)  # samples per label frame

    events = []
    start = None
    for i in range(len(single) + 1):
        here = single[i] if i < len(single) else False
        same = (start is not None and here
                and cls_per_frame[i] == cls_per_frame[start])
        if here and start is None:
            start = i
        elif start is not None and not same:
            length = i - start
            if length >= min_frames:
                events.append((
                    int(cls_per_frame[start]),
                    wav[:, start * spf:(start + length) * spf].copy(),
                    label[start:start + length].copy(),
                ))
            start = i if here else None
    return events


def build_event_banks(clips: Sequence[Tuple[np.ndarray, np.ndarray]],
                      sr: int = 24000, n_classes: Optional[int] = None,
                      min_frames: int = 10
                      ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Concatenate all single-class events per class into (tdm_x, tdm_y)
    banks. n_classes defaults to the labels' 4C width / 4."""
    if n_classes is None and clips:
        n_classes = clips[0][1].shape[1] // 4
    per_class_wav: Dict[int, list] = {c: [] for c in range(n_classes)}
    per_class_lab: Dict[int, list] = {c: [] for c in range(n_classes)}
    for wav, label in clips:
        for cls, w, l in extract_single_class_events(
                wav, label, sr=sr, n_classes=n_classes, min_frames=min_frames):
            per_class_wav[cls].append(w)
            per_class_lab[cls].append(l)

    tdm_x, tdm_y = [], []
    for c in range(n_classes):
        if per_class_wav[c]:
            tdm_x.append(np.concatenate(per_class_wav[c], axis=-1))
            tdm_y.append(np.concatenate(per_class_lab[c], axis=0))
        else:
            tdm_x.append(np.zeros((4, 0), np.float32))
            tdm_y.append(np.zeros((0, 4 * n_classes), np.float32))
    return tdm_x, tdm_y


def tdm_aug(x: List[np.ndarray], y: List[np.ndarray],
            tdm_x: Sequence[np.ndarray], tdm_y: Sequence[np.ndarray],
            rng: np.random.RandomState,
            sr: int = 24000, label_resolution: float = 0.1,
            max_overlap_num: int = 5, max_overlap_per_frame: int = 2,
            min_overlap_sec: float = 1, max_overlap_sec: float = 5
            ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Paste random bank events into clips, in place (data_loader.py:188-234).

    x: clips [chan, samples]; y: labels [frames, 4C].
    """
    n_classes = y[0].shape[-1] // 4
    min_frames = int(min_overlap_sec / label_resolution)
    max_frames = int(max_overlap_sec / label_resolution)
    spf = int(sr * label_resolution)

    sizes = np.asarray([max(t.shape[0], 1) for t in tdm_y], np.float64)
    weight = (1.0 / sizes)
    weight[np.asarray([t.shape[0] == 0 for t in tdm_y])] = 0.0
    if weight.sum() == 0:
        return x, y
    weight /= weight.sum()

    for i in range(len(x)):
        selected = rng.choice(n_classes, size=max_overlap_num, p=weight)
        for cls in selected:
            # labels are zero-padded to a fixed length but wavs are not:
            # place events only where audio exists
            frames_total = min(y[i].shape[0], x[i].shape[1] // spf)
            bank_frames = tdm_y[cls].shape[0]
            if bank_frames <= max_frames:
                continue
            dur = rng.randint(min_frames, max_frames)
            if frames_total <= dur:
                continue
            offset = rng.randint(0, frames_total - dur)
            td_offset = rng.randint(0, bank_frames - dur)

            frame_y = y[i][offset:offset + dur]
            nondup = 1.0 - frame_y[:, cls]
            valid = ((frame_y[:, :n_classes].sum(-1)
                      < max_overlap_per_frame).astype(nondup.dtype) * nondup)
            if valid.sum() == 0:
                continue

            event_y = tdm_y[cls][td_offset:td_offset + dur] * valid[:, None]
            y[i][offset:offset + dur] += event_y

            valid_wav = np.repeat(valid, spf)
            event_x = (tdm_x[cls][:, td_offset * spf:(td_offset + dur) * spf]
                       * valid_wav[None, :])
            x[i][:, offset * spf:(offset + dur) * spf] += event_x
    return x, y
