"""STFT (seld_tpu/ops/stft.py).

Numerics of torchaudio.functional.spectrogram as the reference calls it: a
periodic Hann window of `win_length` zero-padded symmetrically to `n_fft`,
centered frames with reflect padding, no normalization, complex output.

Two routes, as in the JAX package:
  - ``method='fft'``    : torch.fft.rfft over the windowed frames
  - ``method='matmul'`` : the real DFT as two products against the cos/sin
    bases of `_dft_bases` (numpy, f32)
The default is 'fft'. The window and the bases are numpy copies of the JAX
package's, so both routes see its exact constants.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def _hann_np(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)


def _padded_window_np(n_fft: int, win_length: int) -> np.ndarray:
    """Window of `win_length`, centered in a length-`n_fft` buffer (f32)."""
    w = _hann_np(win_length)
    if win_length == n_fft:
        return w
    left = (n_fft - win_length) // 2
    return np.pad(w, (left, n_fft - win_length - left))


def hann_window(win_length: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window default)."""
    return torch.as_tensor(_hann_np(win_length), device=device).to(dtype)


def _padded_window(n_fft: int, win_length: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    return torch.as_tensor(_padded_window_np(n_fft, win_length),
                           device=device).to(dtype)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by `pad` on both sides (numpy's 'reflect':
    the edge sample is not repeated)."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    return torch.nn.functional.pad(flat, (pad, pad), mode="reflect").reshape(
        *lead, x.shape[-1] + 2 * pad)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int,
                 center: bool = True) -> torch.Tensor:
    """[..., T] -> [..., n_frames, frame_length] (reflect-padded if
    centered)."""
    if center:
        x = reflect_pad(x, frame_length // 2)
    return x.unfold(-1, frame_length, hop)


@functools.lru_cache(maxsize=8)
def _dft_bases(n_fft: int) -> tuple:
    """Real-input DFT bases: cos/sin matrices [n_fft, n_fft//2 + 1] (numpy)."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def stft(x: torch.Tensor,
         n_fft: int = 512,
         hop_length: Optional[int] = None,
         win_length: Optional[int] = None,
         center: bool = True,
         method: Optional[str] = None) -> torch.Tensor:
    """Complex STFT of [..., T] -> complex64 [..., n_frames, n_fft//2 + 1]."""
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = win_length // 2
    method = method or "fft"

    window = _padded_window(n_fft, win_length, x.dtype, x.device)
    frames = frame_signal(x, n_fft, hop_length, center=center) * window

    if method == "fft":
        return torch.fft.rfft(frames, n=n_fft, dim=-1)
    if method != "matmul":
        raise ValueError(f"unknown stft method {method!r}")
    cos_b, sin_b = (torch.as_tensor(b, device=x.device).to(frames.dtype)
                    for b in _dft_bases(n_fft))
    return torch.complex(frames @ cos_b, frames @ sin_b)


def complex_spec(wav: torch.Tensor,
                 pad: int = 0,
                 n_fft: int = 512,
                 win_length: Optional[int] = None,
                 hop_length: Optional[int] = None,
                 normalized: bool = False,
                 method: Optional[str] = None) -> torch.Tensor:
    """[chan, T] wav -> complex spec [chan, freq, time] (optional
    end-padding, centered STFT, optional window-energy normalization)."""
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = win_length // 2
    if pad > 0:
        wav = torch.nn.functional.pad(wav, (pad, pad))

    spec = stft(wav, n_fft=n_fft, hop_length=hop_length,
                win_length=win_length, method=method)  # [chan, time, freq]
    if normalized:
        window = _padded_window(n_fft, win_length, wav.dtype, wav.device)
        spec = spec / torch.sqrt(torch.sum(window ** 2))
    return spec.transpose(-1, -2)  # [chan, freq, time]
