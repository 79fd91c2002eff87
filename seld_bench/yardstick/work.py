"""Operations and bytes of the port's kernels, counted from shapes.

Each input is read once and each output written once, whatever a kernel
reads again; operations are those of the algorithm, not of the scheme a
kernel runs. The shapes are the work a cell's items need (a clip's 541
windows, a step's batch), not the padded rows a path may launch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


class GRULaunch(NamedTuple):
    """One biGRU layer's recurrence: D directions, T steps, B rows, U units;
    `io_bytes` the element size of x_proj, hs and the incoming gradient,
    `rk_bytes` that of the recurrent kernel."""
    d: int
    t: int
    b: int
    u: int
    io_bytes: int
    rk_bytes: int


def gru_fwd_work(g: GRULaunch):
    """(flops, bytes) of the forward recurrence: the h @ Rk product a step
    (2 D T B U 3U) and the gates' arithmetic (10 D T B U); x_proj read and
    hs written, Rk and the recurrent bias read."""
    flops = 2 * g.d * g.t * g.b * g.u * 3 * g.u + 10 * g.d * g.t * g.b * g.u
    nbytes = (g.d * g.t * g.b * 4 * g.u * g.io_bytes
              + g.d * g.u * 3 * g.u * g.rk_bytes + g.d * 3 * g.u * 4)
    return flops, nbytes


def gru_bwd_work(g: GRULaunch):
    """(flops, bytes) of the backward: three B x U x 3U products a step and
    direction (the recomputed h @ Rk, dh = dhp @ Rk^T, dRk = h^T dhp);
    x_proj, hs and the gradient read and dx_proj written, Rk and the bias
    read and their gradients written."""
    flops = 3 * 2 * g.d * g.t * g.b * g.u * 3 * g.u
    xp = g.d * g.t * g.b * 3 * g.u
    hs = g.d * g.t * g.b * g.u
    nbytes = ((2 * xp + 2 * hs) * g.io_bytes
              + 2 * (g.d * g.u * 3 * g.u * g.rk_bytes + g.d * 3 * g.u * 4))
    return flops, nbytes


def hann(n: int) -> np.ndarray:
    """Periodic Hann window."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(
        np.float32)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: float = None) -> np.ndarray:
    """[n_freqs, n_mels] HTK triangular filterbank, unnormalised (the
    one torchaudio's MelScale builds)."""
    f_max = sample_rate // 2 if f_max is None else f_max

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def frontend_work(n: int, t: int, n_fft: int = 1024, n_mels: int = 64,
                  hop: int = 480, sample_rate: int = 24000):
    """(flops, bytes) of the FOA front-end for n clips of t frames: per
    frame and channel a real FFT (2.5 N log2 N) and the window (N); per bin
    the power of 4 channels (3 each) and the 3 intensity components with
    their norm (18); the filterbank's non-zeros for the 4 power and 3 IV
    rows (2 each). Bytes: the padded wav read, the 7 feature planes
    written, f32."""
    nnz = int(np.count_nonzero(mel_filterbank(n_fft // 2 + 1, n_mels,
                                              sample_rate)))
    bins = n_fft // 2 + 1
    per_frame = (4 * (2.5 * n_fft * math.log2(n_fft) + n_fft)
                 + bins * (4 * 3 + 18) + 7 * nnz * 2)
    lp = (t - 1) * hop + n_fft
    nbytes = (n * 4 * lp + n * 7 * t * n_mels) * 4
    return n * t * per_frame, nbytes
