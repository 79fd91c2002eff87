"""SELD feature front-end: log-mel + FOA intensity vectors
(seld_tpu/ops/features.py).

  - extract_features            [chan, T] wav -> [time, n_mels, 7]
  - extract_features_batch      [N, chan, T] -> [N, time, n_mels, 7]
  - extract_features_clips      a list of clips, bucketed and chunked
  - foa_intensity_vectors, extract_labels, preprocess_features_labels,
    calculate_statistics, apply_normalizer

On a CUDA tensor FOA extraction runs the fused front-end kernel
(ops/frontend.py) where it takes the shape (`frontend_applicable`: 64 mels,
n_fft 1024); a CPU tensor, and any other shape on the card, runs the plain
composition of the JAX package (complex spectrum, |X|^2, mel projection,
intensity vectors), as the JAX package composes every shape with XLA.
Integer PCM is scaled to [-1, 1) first, exactly as the loader's int /
2^(bits-1).

Not ported yet (ROADMAP queue 1, item 8): the microphone-array features
(`mode="mic"`, GCC-PHAT) and SALSA-lite.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from seld_tpu_torch.ops.frontend import (frontend_applicable,
                                         fused_foa_frontend)
from seld_tpu_torch.ops.mel import (amplitude_to_db, apply_melscale,
                                    mel_filterbank)
from seld_tpu_torch.ops.stft import complex_spec
from seld_tpu_torch.utils.coords import polar_to_cartesian

_PCM_SCALE = {torch.int16: 32768.0, torch.int32: 2147483648.0}
_UNPORTED = ("the microphone-array features (GCC-PHAT, SALSA-lite) are not "
             "ported yet (ROADMAP queue 1, item 8)")


def foa_intensity_vectors(spec: torch.Tensor, eps: float = 1e-8
                          ) -> torch.Tensor:
    """FOA acoustic intensity vectors from a complex spec [4, freq, time]
    (ACN W, Y, Z, X): Re(conj(W) {X, Y, Z}), L2-normalised across (x, y, z)
    with an eps floor. Returns [3, freq, time] real."""
    w = torch.conj(spec[0])
    ivx = torch.real(w * spec[3])
    ivy = torch.real(w * spec[1])
    ivz = torch.real(w * spec[2])
    norm = torch.clamp_min(torch.sqrt(ivx ** 2 + ivy ** 2 + ivz ** 2), eps)
    return torch.stack([ivx / norm, ivy / norm, ivz / norm], dim=0)


def gcc_features(spec, n_mels):
    raise NotImplementedError(_UNPORTED)


def salsa_lite_features(spec, *args, **kwargs):
    raise NotImplementedError(_UNPORTED)


def _to_float(wav: torch.Tensor) -> torch.Tensor:
    if wav.dtype in _PCM_SCALE:
        return wav.float() / _PCM_SCALE[wav.dtype]
    if not wav.is_floating_point():
        raise TypeError(f"wav dtype {wav.dtype}: int16/int32 PCM or float")
    return wav.float()


def _extract_plain(wav: torch.Tensor, sample_rate, n_mels, n_fft,
                   win_length, hop_length, method) -> torch.Tensor:
    spec = complex_spec(wav, n_fft=n_fft, win_length=win_length,
                        hop_length=hop_length, method=method)
    fbank = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate,
                           device=wav.device)
    mel_spec = amplitude_to_db(apply_melscale(spec.abs() ** 2, fbank))
    iv = apply_melscale(foa_intensity_vectors(spec), fbank)
    return torch.cat([mel_spec, iv], dim=0).permute(2, 1, 0)


def extract_features_batch(wavs: torch.Tensor,
                           sample_rate: int = 24000,
                           mode: str = "foa",
                           n_mels: int = 64,
                           n_fft: int = 1024,
                           win_length: int = 960,
                           hop_length: int = 480,
                           method: Optional[str] = None) -> torch.Tensor:
    """[N, chan, T] equal-length wavs -> [N, time, n_mels, 7]. On the card
    one launch of the front-end kernel for the batch where
    `frontend_applicable` holds, else the plain composition there too;
    `method` picks the plain composition's DFT ('fft' or 'matmul')."""
    if mode == "mic":
        raise NotImplementedError(_UNPORTED)
    if mode != "foa":
        raise ValueError(f"invalid mode: {mode!r}")
    wavs = _to_float(wavs)
    if wavs.device.type == "cuda" and frontend_applicable(n_mels, n_fft,
                                                          win_length):
        return fused_foa_frontend(wavs, sample_rate=sample_rate,
                                  n_mels=n_mels, n_fft=n_fft,
                                  win_length=win_length,
                                  hop_length=hop_length)
    return torch.stack([_extract_plain(w, sample_rate, n_mels, n_fft,
                                       win_length, hop_length, method)
                        for w in wavs])


def extract_features(wav: torch.Tensor, sample_rate: int = 24000,
                     mode: str = "foa", n_mels: int = 64, n_fft: int = 1024,
                     win_length: int = 960, hop_length: int = 480,
                     method: Optional[str] = None) -> torch.Tensor:
    """[chan, T] wav -> [time, n_mels, 7]: 4 log-mel + 3 mel-projected IV."""
    return extract_features_batch(
        wav[None], sample_rate=sample_rate, mode=mode, n_mels=n_mels,
        n_fft=n_fft, win_length=win_length, hop_length=hop_length,
        method=method)[0]


def extract_features_clips(wavs: Sequence, *, chunk_size: int = 8,
                           device="cuda", **kwargs) -> list:
    """A list of [chan, T] clips (numpy or torch) -> a list of per-clip
    [time, n_mels, C] numpy arrays, in input order.

    Clips are bucketed by shape and dtype (stacking an int16 clip with an
    int32 one would promote without rescaling), then each bucket goes to
    `device` and through `extract_features_batch` `chunk_size` clips at a
    time."""
    wavs = list(wavs)
    out = [None] * len(wavs)
    buckets = {}
    for i, w in enumerate(wavs):
        buckets.setdefault((tuple(w.shape), str(w.dtype)), []).append(i)
    for idxs in buckets.values():
        for s in range(0, len(idxs), chunk_size):
            sel = idxs[s:s + chunk_size]
            if isinstance(wavs[sel[0]], torch.Tensor):
                stacked = torch.stack([wavs[i] for i in sel])
            else:   # one copy, also of read-only buffers (np.frombuffer)
                stacked = torch.from_numpy(np.stack([wavs[i] for i in sel]))
            feats = extract_features_batch(stacked.to(device), **kwargs)
            feats = feats.cpu().numpy()
            for j, i in enumerate(sel):
                out[i] = feats[j]
    return out


def extract_labels(path: str, n_classes: int = 14,
                   max_frames: Optional[int] = None) -> np.ndarray:
    """DCASE metadata CSV -> [frames, 4*n_classes] (one-hot SED + cartesian
    DOA). CSV rows: frame, class, track, azimuth_deg, elevation_deg; output
    layout per frame: [sed(C), x(C), y(C), z(C)] flattened."""
    rows = []
    with open(path, "r") as f:
        for line in f.readlines():
            frame, cls, _, azi, ele = list(map(int, line.split(",")))
            rows.append([frame, cls, azi, ele])
    labels = np.stack(rows, axis=0)

    labels = np.concatenate(
        [labels[..., :2], polar_to_cartesian(labels[..., 2:])], axis=-1)

    output_len = int(labels[..., 0].max()) + 1
    if max_frames is not None:
        output_len = max(max_frames, output_len)
    outputs = np.zeros((output_len, 4, n_classes), dtype="float32")
    for label in labels:
        outputs[int(label[0]), :, int(label[1])] = [1.0, *label[2:]]
    return outputs.reshape([-1, 4 * n_classes])


def preprocess_features_labels(features: np.ndarray,
                               labels: np.ndarray,
                               max_label_length: int = 600,
                               multiplier: int = 5
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate to fixed geometry: feats [max*mult, F, C], labels
    [max, 4C]."""
    cur_len = labels.shape[0]
    max_len = max_label_length
    if cur_len < max_len:
        labels = np.pad(labels, ((0, max_len - cur_len), (0, 0)), "constant")
    else:
        labels = labels[:max_len]

    cur_len = features.shape[0]
    max_len = max_label_length * multiplier
    if cur_len < max_len:
        features = np.pad(features, ((0, max_len - cur_len), (0, 0), (0, 0)),
                          "constant")
    else:
        features = features[:max_len]
    return features, labels


def calculate_statistics(features: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Dataset-wide per-(freq, chan) mean/std over concatenated frames."""
    mean = features.mean(axis=0, keepdims=True)
    std = features.std(axis=0, keepdims=True)
    return mean, std


def apply_normalizer(features, mean, std, eps: float = 1e-8):
    if isinstance(features, torch.Tensor):
        mean, std = torch.as_tensor(mean), torch.as_tensor(std)
        return (features - mean) / torch.clamp_min(std, eps)
    return (features - mean) / np.maximum(std, eps)
