"""The fused FOA feature front-end (seld_tpu/ops/pallas/frontend.py).

`foa_frontend` takes a chunk of n reflect-padded 4-channel clips and gives
their mel power [n, 4, T, 64] and mel-projected unit intensity vectors
[n, 3, T, 64]: the windowed real DFT as products against the bases, |X|^2,
the HTK filterbank, and Re(conj(W) {X, Y, Z}) L2-normalised with an eps
floor (ACN channel order W, Y, Z, X). On a CUDA tensor it launches the
hand-written sm_90a kernel in csrc/foa_frontend.cu, which keeps the complex
spectrum on chip; on a CPU tensor it runs `foa_frontend_ref`, the plain
PyTorch version. A CUDA tensor the kernel does not take raises.

`fused_foa_frontend` wraps it with what the JAX package does around its
kernel: the reflect pad, the per-clip dB step and the concatenation to
[time, n_mels, 7]. The JAX package's two layouts (`fused_foa_frontend` and
`fused_foa_frontend_2d`) differ only in how frames were tiled for the TPU;
here one kernel serves both names.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from seld_tpu_torch.ops import kernels
from seld_tpu_torch.ops.mel import _mel_filterbank_np, amplitude_to_db
from seld_tpu_torch.ops.stft import _dft_bases, _padded_window_np, reflect_pad

_SOURCE = "foa_frontend.cu"
_BINS = 32       # csrc/foa_frontend.cu kBins: bins per chunk
_K_TILE = 32     # kK: n_fft must be a multiple of it
_MELS = 64       # kMels: the kernel's filterbank width


@functools.lru_cache(maxsize=4)
def _frontend_constants(n_fft: int, win_length: int, n_mels: int,
                        sample_rate: int) -> Tuple[np.ndarray, ...]:
    """(windowed cos basis, windowed sin basis) [n_fft, n_bins] and the mel
    filterbank [n_bins, n_mels], f32 numpy: the JAX package's values without
    its lane padding."""
    n_bins = n_fft // 2 + 1
    cos_b, sin_b = _dft_bases(n_fft)
    window = _padded_window_np(n_fft, win_length)[:, None]
    fbank = _mel_filterbank_np(n_bins, n_mels, sample_rate, 0.0,
                               float(sample_rate // 2))
    return window * cos_b, window * sin_b, fbank


@functools.lru_cache(maxsize=4)
def _kernel_constants(n_fft: int, win_length: int, n_mels: int,
                      sample_rate: int, device: torch.device):
    """The kernel's layout of the constants on `device`: wcat [n_fft,
    chunks * 64] (per 32-bin chunk, its cos columns then its sin columns)
    and the filterbank [chunks * 32, n_mels], zero past the last bin."""
    wre, wim, fbank = _frontend_constants(n_fft, win_length, n_mels,
                                          sample_rate)
    n_bins = wre.shape[1]
    chunks = -(-n_bins // _BINS)
    pad = chunks * _BINS - n_bins
    wre = np.pad(wre, ((0, 0), (0, pad))).reshape(n_fft, chunks, 1, _BINS)
    wim = np.pad(wim, ((0, 0), (0, pad))).reshape(n_fft, chunks, 1, _BINS)
    wcat = np.concatenate([wre, wim], axis=2).reshape(n_fft, -1)
    fb = np.pad(fbank, ((0, pad), (0, 0)))
    return (torch.from_numpy(np.ascontiguousarray(wcat)).to(device),
            torch.from_numpy(np.ascontiguousarray(fb)).to(device), chunks)


def foa_frontend_ref(wav: torch.Tensor, *, n_fft: int = 1024,
                     win_length: int = 960, hop_length: int = 480,
                     n_mels: int = 64, sample_rate: int = 24000,
                     eps: float = 1e-8):
    """Plain PyTorch version: padded wav [n, 4, Lp] f32 -> (mel [n, 4, T,
    n_mels], iv [n, 3, T, n_mels]), as the JAX kernel's body computes them."""
    wre, wim, fbank = (torch.as_tensor(a, device=wav.device) for a in
                       _frontend_constants(n_fft, win_length, n_mels,
                                           sample_rate))
    frames = wav.unfold(-1, n_fft, hop_length)          # [n, 4, T, n_fft]
    re = frames @ wre
    im = frames @ wim
    mel = (re * re + im * im) @ fbank
    ivx = re[:, 0] * re[:, 3] + im[:, 0] * im[:, 3]
    ivy = re[:, 0] * re[:, 1] + im[:, 0] * im[:, 1]
    ivz = re[:, 0] * re[:, 2] + im[:, 0] * im[:, 2]
    norm = torch.clamp_min(torch.sqrt(ivx * ivx + ivy * ivy + ivz * ivz), eps)
    iv = torch.stack([ivx / norm, ivy / norm, ivz / norm], dim=1) @ fbank
    return mel, iv


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load(_SOURCE)
    lib.seld_foa_frontend.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    lib.seld_foa_frontend.restype = ctypes.c_int
    return lib


def _foa_frontend_cuda(wav, n_fft, win_length, hop_length, n_mels,
                       sample_rate, eps):
    if wav.dtype != torch.float32 or not wav.is_contiguous():
        raise ValueError("the front-end kernel takes a contiguous float32 "
                         f"wav; got {wav.dtype}, contiguous "
                         f"{wav.is_contiguous()}")
    if n_mels != _MELS or n_fft % _K_TILE:
        raise ValueError(f"the front-end kernel takes {_MELS} mels and an "
                         f"n_fft that is a multiple of {_K_TILE}; got "
                         f"{n_mels}, {n_fft}")
    n, _, lp = wav.shape
    if lp < n_fft or n * 4 * lp >= 2 ** 31:
        raise ValueError(f"padded length {lp} is shorter than n_fft or too "
                         "long for the kernel's indices")
    t = 1 + (lp - n_fft) // hop_length
    wcat, fbank, chunks = _kernel_constants(n_fft, win_length, n_mels,
                                            sample_rate, wav.device)
    mel = torch.empty((n, 4, t, n_mels), dtype=torch.float32,
                      device=wav.device)
    iv = torch.empty((n, 3, t, n_mels), dtype=torch.float32,
                     device=wav.device)
    lib = _library()
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        err = lib.seld_foa_frontend(
            wav.data_ptr(), wcat.data_ptr(), fbank.data_ptr(),
            mel.data_ptr(), iv.data_ptr(), n, lp, t, hop_length, n_fft,
            chunks, eps, stream)
    kernels.check(lib, err, "foa_frontend launch")
    kernels.launch_counts["foa_frontend"] += 1
    return mel, iv


def foa_frontend(wav: torch.Tensor, *, n_fft: int = 1024,
                 win_length: int = 960, hop_length: int = 480,
                 n_mels: int = 64, sample_rate: int = 24000,
                 eps: float = 1e-8):
    """Mel power and mel-projected unit IV of a chunk of padded clips.

    Args:
      wav: [n, 4, L + n_fft] float32, each clip reflect-padded by n_fft / 2
        on both sides (`reflect_pad`).
    Returns (mel [n, 4, T, n_mels], iv [n, 3, T, n_mels]) f32, T = 1 + L //
    hop_length, mel before the dB step. A CPU tensor runs
    `foa_frontend_ref`; a CUDA tensor runs the kernel or raises.
    """
    if wav.dim() != 3 or wav.shape[1] != 4:
        raise ValueError("fused FOA frontend expects [n, 4, samples]; got "
                         f"{tuple(wav.shape)}")
    kwargs = dict(n_fft=n_fft, win_length=win_length, hop_length=hop_length,
                  n_mels=n_mels, sample_rate=sample_rate, eps=eps)
    if wav.device.type == "cpu":
        return foa_frontend_ref(wav, **kwargs)
    if wav.device.type == "cuda":
        return _foa_frontend_cuda(wav, **kwargs)
    raise ValueError(f"foa_frontend runs on cpu or cuda, not {wav.device}")


def fused_foa_frontend(wav: torch.Tensor,
                       sample_rate: int = 24000,
                       n_mels: int = 64,
                       n_fft: int = 1024,
                       win_length: int = 960,
                       hop_length: int = 480,
                       eps: float = 1e-8) -> torch.Tensor:
    """[4, L] (or [n, 4, L]) float FOA wav -> [time, n_mels, 7] (or [n,
    ...]) features: 4 log-mel (dB, top_db 80, the floor per clip) + 3
    mel-projected intensity vectors (extract_features parity)."""
    if wav.dim() < 2 or wav.shape[-2] != 4:
        raise ValueError("fused FOA frontend expects 4 input channels")
    single = wav.dim() == 2
    batch = wav.reshape(-1, 4, wav.shape[-1]).float()
    padded = reflect_pad(batch, n_fft // 2).contiguous()
    mel, iv = foa_frontend(padded, n_fft=n_fft, win_length=win_length,
                           hop_length=hop_length, n_mels=n_mels,
                           sample_rate=sample_rate, eps=eps)
    mel_db = amplitude_to_db(mel, clip_dims=1)
    features = torch.cat([mel_db, iv], dim=1).permute(0, 2, 3, 1)
    return features[0] if single else features.reshape(
        *wav.shape[:-2], *features.shape[1:])


# the JAX package's 2-D-block layout variant: the same function here
fused_foa_frontend_2d = fused_foa_frontend
