"""Mel filterbank and dB conversion (seld_tpu/ops/mel.py).

  - the HTK triangular filterbank of torchaudio's MelScale (f_min 0, f_max
    sr/2, no normalization), built in numpy by `_mel_filterbank_np`, a copy
    of the JAX package's (torchaudio is not a dependency of the port);
  - amplitude_to_DB(multiplier 10, amin 1e-10, db_multiplier 0, top_db 80)
    with the top-dB floor taken over one clip's whole tensor.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def hz_to_mel(freq):
    """HTK mel scale."""
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_np(n_freqs: int, n_mels: int, sample_rate: int,
                       f_min: float, f_max: float) -> np.ndarray:
    """[n_freqs, n_mels] triangular filterbank (HTK, unnormalized)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = hz_to_mel(f_min)
    m_max = hz_to_mel(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = mel_to_hz(m_pts)  # [n_mels + 2]

    # triangular filters: rise from f_pts[i] to f_pts[i+1], fall to f_pts[i+2]
    f_diff = f_pts[1:] - f_pts[:-1]                     # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]        # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[:-1]                # [n_freqs, n_mels]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def mel_filterbank(n_freqs: int,
                   n_mels: int = 64,
                   sample_rate: int = 24000,
                   f_min: float = 0.0,
                   f_max: Optional[float] = None,
                   device=None) -> torch.Tensor:
    """[n_freqs, n_mels] HTK triangular filterbank (f32)."""
    if f_max is None:
        f_max = float(sample_rate // 2)
    return torch.as_tensor(_mel_filterbank_np(
        n_freqs, n_mels, sample_rate, float(f_min), float(f_max)),
        device=device)


def apply_melscale(spec: torch.Tensor, fbank: torch.Tensor) -> torch.Tensor:
    """[..., freq, time] @ fbank[freq, n_mels] -> [..., n_mels, time]."""
    return torch.einsum("...ft,fm->...mt", spec, fbank)


def amplitude_to_db(x: torch.Tensor,
                    multiplier: float = 10.0,
                    amin: float = 1e-10,
                    db_multiplier: float = 0.0,
                    top_db: Optional[float] = 80.0,
                    clip_dims: int = 0) -> torch.Tensor:
    """Power -> dB with a top-dB floor per clip.

    The floor is (max - top_db) over each clip's tensor: the whole tensor
    when `clip_dims` is 0, else each slice along the leading `clip_dims`
    axes (a batch of clips; one max over the batch would floor a quiet clip
    at a loud clip's level)."""
    x_db = multiplier * torch.log10(torch.clamp_min(x, amin))
    x_db = x_db - multiplier * db_multiplier
    if top_db is not None:
        if clip_dims:
            peak = x_db.flatten(clip_dims).amax(dim=-1)
            peak = peak.reshape(*peak.shape, *([1] * (x_db.dim() - clip_dims)))
        else:
            peak = x_db.max()
        x_db = torch.maximum(x_db, peak - top_db)
    return x_db
