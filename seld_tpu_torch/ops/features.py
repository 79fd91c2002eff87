"""SELD feature front-end: log-mel + FOA intensity vectors or GCC-PHAT
(seld_tpu/ops/features.py).

  - extract_features            [chan, T] wav -> [time, n_mels, C]
  - extract_features_batch      [N, chan, T] -> [N, time, n_mels, C]
  - extract_features_clips      a list of clips, bucketed and chunked
  - foa_intensity_vectors, gcc_features, salsa_lite_features,
    extract_labels, preprocess_features_labels, calculate_statistics,
    apply_normalizer

C is 7 in mode "foa" (4 log-mel + 3 mel-projected intensity vectors) and
10 in mode "mic" (4 log-mel + 6 GCC-PHAT pairs). On a CUDA tensor FOA
extraction runs the fused front-end kernel (ops/frontend.py) where it takes
the shape (`frontend_applicable`: 64 mels, n_fft 1024); a CPU tensor, any
other FOA shape on the card and mode "mic" everywhere run the plain
composition of the JAX package (complex spectrum, |X|^2, mel projection,
intensity vectors or GCC-PHAT through `torch.fft.irfft`), as the JAX
package composes them with XLA. The kernel computes intensity vectors, not
GCC: mode "mic" never reaches it. Integer PCM is scaled to [-1, 1) first,
exactly as the loader's int / 2^(bits-1).
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
from seld_tpu_torch.utils.profiling import span

_PCM_SCALE = {torch.int16: 32768.0, torch.int32: 2147483648.0}
FEATURE_CHANNELS = {"foa": 7, "mic": 10}


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


def gcc_features(spec: torch.Tensor, n_mels: int) -> torch.Tensor:
    """GCC-PHAT for every mic pair (m, n), m < n, in order, from a complex
    spec [n_chan, freq, time]: irfft(exp(i * angle(conj(S_m) S_n))) along
    freq, centre-cropped to n_mels lags. Returns [n_pairs, n_mels, time].

    exp(i * angle(r)), as the reference computes it: angle(0) = 0, so a
    silent bin gives unit phase (a delta at lag 0), not the 0 that r / |r|
    would give."""
    n_chan = spec.shape[0]
    pairs = [(m, n) for m in range(n_chan) for n in range(m + 1, n_chan)]
    first = spec[[m for m, _ in pairs]]
    second = spec[[n for _, n in pairs]]
    angle = torch.angle(torch.conj(first) * second)
    phase = torch.polar(torch.ones_like(angle), angle)
    cc = torch.fft.irfft(phase, dim=1)                 # [pairs, n_fft, time]
    return torch.cat([cc[:, -(n_mels // 2):],
                      cc[:, :(n_mels + 1) // 2]], dim=1)


def salsa_lite_features(spec: torch.Tensor, sample_rate: int = 24000,
                        n_fft: Optional[int] = None, d_max: float = 0.042,
                        freq_clip_hz: float = 9000.0) -> torch.Tensor:
    """SALSA-Lite spatial features for microphone arrays (arXiv
    2110.00275): log-power spectrograms of all M channels and the M - 1
    frequency-normalised inter-channel phase differences c / (2 pi f) *
    arg(conj(S_0) S_m), zero outside [50 Hz, min(c / (2 d_max),
    freq_clip_hz)] (above it the phase wraps; near DC the 1/f scale blows
    up). spec: complex [n_chan, freq, time] -> [time, freq, 2M - 1]."""
    _, n_bins, _ = spec.shape
    if n_fft is None:
        n_fft = 2 * (n_bins - 1)
    c_sound = 343.0
    log_power = torch.log(spec.abs() ** 2 + 1e-10)             # [M, F, T]
    freqs = torch.arange(n_bins, device=spec.device) * (sample_rate / n_fft)
    scale = c_sound / (2.0 * np.pi * torch.clamp_min(freqs, 1.0))
    nipd = torch.angle(torch.conj(spec[0])[None] * spec[1:])   # [M-1, F, T]
    nipd = nipd * scale[None, :, None]
    f_alias = min(c_sound / (2.0 * d_max), freq_clip_hz)
    mask = ((freqs >= 50.0) & (freqs <= f_alias)).to(nipd.dtype)
    nipd = nipd * mask[None, :, None]
    return torch.cat([log_power, nipd], dim=0).permute(2, 1, 0)


def _to_float(wav: torch.Tensor) -> torch.Tensor:
    if wav.dtype in _PCM_SCALE:
        return wav.float() / _PCM_SCALE[wav.dtype]
    if not wav.is_floating_point():
        raise TypeError(f"wav dtype {wav.dtype}: int16/int32 PCM or float")
    return wav.float()


def _extract_plain(wav: torch.Tensor, mode, sample_rate, n_mels, n_fft,
                   win_length, hop_length, method) -> torch.Tensor:
    spec = complex_spec(wav, n_fft=n_fft, win_length=win_length,
                        hop_length=hop_length, method=method)
    fbank = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate,
                           device=wav.device)
    mel_spec = amplitude_to_db(apply_melscale(spec.abs() ** 2, fbank))
    if mode == "foa":
        spatial = apply_melscale(foa_intensity_vectors(spec), fbank)
    else:
        spatial = gcc_features(spec, n_mels=n_mels)
    return torch.cat([mel_spec, spatial], dim=0).permute(2, 1, 0)


def extract_features_batch(wavs: torch.Tensor,
                           sample_rate: int = 24000,
                           mode: str = "foa",
                           n_mels: int = 64,
                           n_fft: int = 1024,
                           win_length: int = 960,
                           hop_length: int = 480,
                           method: Optional[str] = None) -> torch.Tensor:
    """[N, chan, T] equal-length wavs -> [N, time, n_mels, C]. In mode
    "foa" on the card, one launch of the front-end kernel for the batch
    where `frontend_applicable` holds; mode "mic", and every other case,
    runs the plain composition; `method` picks its DFT ('fft' or
    'matmul')."""
    if mode not in FEATURE_CHANNELS:
        raise ValueError(f"invalid mode: {mode!r}")
    wavs = _to_float(wavs)
    if mode == "foa" and wavs.device.type == "cuda" and frontend_applicable(
            n_mels, n_fft, win_length):
        return fused_foa_frontend(wavs, sample_rate=sample_rate,
                                  n_mels=n_mels, n_fft=n_fft,
                                  win_length=win_length,
                                  hop_length=hop_length)
    return torch.stack([_extract_plain(w, mode, sample_rate, n_mels, n_fft,
                                       win_length, hop_length, method)
                        for w in wavs])


def extract_features(wav: torch.Tensor, sample_rate: int = 24000,
                     mode: str = "foa", n_mels: int = 64, n_fft: int = 1024,
                     win_length: int = 960, hop_length: int = 480,
                     method: Optional[str] = None) -> torch.Tensor:
    """[chan, T] wav -> [time, n_mels, C]: 4 log-mel + 3 mel-projected IV
    (mode "foa", C = 7) or + 6 GCC-PHAT pairs (mode "mic", C = 10)."""
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
    with span("seld.score.normalize"):
        if isinstance(features, torch.Tensor):
            mean, std = torch.as_tensor(mean), torch.as_tensor(std)
            return (features - mean) / torch.clamp_min(std, eps)
        return (features - mean) / np.maximum(std, eps)
