"""The fused FOA feature front-end (seld_tpu/ops/pallas/frontend.py).

`foa_frontend` takes a chunk of n reflect-padded 4-channel clips and gives
their mel power [n, 4, T, 64] and mel-projected unit intensity vectors
[n, 3, T, 64]: the windowed real DFT, |X|^2, the HTK filterbank, and
Re(conj(W) {X, Y, Z}) L2-normalised with an eps floor (ACN channel order
W, Y, Z, X). On a CUDA tensor it launches the hand-written sm_90a kernel in
csrc/foa_frontend.cu (a 512-point complex FFT per frame in shared memory,
the real split step, the filterbank as sparse rows; `_kernel_tables` builds
its constants); on a CPU tensor it runs `foa_frontend_ref`, the plain
PyTorch version (the DFT as products against the bases). A CUDA tensor the
kernel does not take raises.

`fused_foa_frontend` wraps it with what the JAX package does around its
kernel: the reflect pad, the per-clip dB step and the concatenation to
[time, n_mels, 7]. The JAX package's two layouts (`fused_foa_frontend` and
`fused_foa_frontend_2d`) differ only in how frames were tiled for the TPU;
here one kernel serves both names.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from seld_tpu_torch.ops import kernels
from seld_tpu_torch.ops.mel import _mel_filterbank_np, amplitude_to_db
from seld_tpu_torch.ops.stft import _dft_bases, _padded_window_np, reflect_pad
from seld_tpu_torch.utils.profiling import span

_SOURCE = "foa_frontend.cu"
_N_FFT = 1024    # csrc/foa_frontend.cu: a 512-point complex FFT per frame
_MELS = 64       # kMels: the kernel's filterbank width
_MAX_NNZ = 2 * (_N_FFT // 2 + 1)   # kMaxNnz: each bin feeds at most 2 mels
# csrc/foa_frontend.cu's twiddle table, complex entries: W_512^(j k1) at
# j * 8 + k1 (j < 64, k1 < 8), W_64^(b c) at _TW2 + b * 8 + c (b, c < 8),
# W_1024^k at _TW3 + k (k < 256)
_TW2, _TW3, _TWIDDLES = 512, 576, 832


def frontend_applicable(n_mels: int, n_fft: int, win_length: int) -> bool:
    """Whether csrc/foa_frontend.cu takes the shape: 64 mels, n_fft 1024
    and 0 < win_length <= n_fft. `extract_features_batch` runs every other
    shape through the plain composition, on either device."""
    return n_mels == _MELS and n_fft == _N_FFT and 0 < win_length <= n_fft


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


def _twiddles() -> np.ndarray:
    """[_TWIDDLES, 2] f32 (re, im) of exp(-2 pi i m / N), computed in float64
    and rounded once, in the kernel's order (see _TW2, _TW3)."""
    j, k1 = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
    b, c = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    ang = np.concatenate([(j * k1).ravel() / 512.0, (b * c).ravel() / 64.0,
                          np.arange(256) / 1024.0]) * (-2.0 * np.pi)
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def _sparse_rows(fbank: np.ndarray):
    """The filterbank [n_bins, n_mels] as one contiguous run of bins per
    mel: (first bin [n_mels], row pointers [n_mels + 1]) int32 and the
    run's weights f32 (a mel with no non-zero has an empty run)."""
    starts, ptr, weights = [], [0], []
    for m in range(fbank.shape[1]):
        nz = np.flatnonzero(fbank[:, m])
        lo, hi = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        starts.append(lo)
        weights.append(fbank[lo:hi, m])
        ptr.append(ptr[-1] + hi - lo)
    return (np.asarray(starts, np.int32), np.asarray(ptr, np.int32),
            np.concatenate(weights).astype(np.float32))


class KernelTables(NamedTuple):
    window: np.ndarray     # [n_fft] f32, the padded periodic Hann window
    twiddles: np.ndarray   # [_TWIDDLES, 2] f32
    fb_index: np.ndarray   # [2 n_mels + 1] int32: first bins, row pointers
    fb_weights: np.ndarray  # [nnz] f32


@functools.lru_cache(maxsize=4)
def _kernel_tables(n_fft: int, win_length: int, n_mels: int,
                   sample_rate: int) -> KernelTables:
    """csrc/foa_frontend.cu's constants, numpy: the window it applies on
    load, its FFT twiddles and the filterbank of `_frontend_constants` as
    sparse rows."""
    starts, ptr, weights = _sparse_rows(
        _frontend_constants(n_fft, win_length, n_mels, sample_rate)[2])
    return KernelTables(_padded_window_np(n_fft, win_length), _twiddles(),
                        np.concatenate([starts, ptr]), weights)


@functools.lru_cache(maxsize=4)
def _kernel_constants(n_fft: int, win_length: int, n_mels: int,
                      sample_rate: int, device: torch.device) -> KernelTables:
    """`_kernel_tables` as contiguous tensors on `device`."""
    return KernelTables(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in _kernel_tables(n_fft, win_length, n_mels,
                                                  sample_rate)))


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
    lib.seld_foa_frontend.argtypes = [ctypes.c_void_p] * 7 + \
        [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    lib.seld_foa_frontend.restype = ctypes.c_int
    return lib


def _foa_frontend_cuda(wav, n_fft, win_length, hop_length, n_mels,
                       sample_rate, eps):
    if wav.dtype != torch.float32 or not wav.is_contiguous():
        raise ValueError("the front-end kernel takes a contiguous float32 "
                         f"wav; got {wav.dtype}, contiguous "
                         f"{wav.is_contiguous()}")
    if not frontend_applicable(n_mels, n_fft, win_length):
        raise ValueError(f"the front-end kernel takes {_MELS} mels, n_fft "
                         f"{_N_FFT} and a window no longer; got {n_mels}, "
                         f"{n_fft}, {win_length}")
    n, _, lp = wav.shape
    if lp < n_fft or n * 4 * lp >= 2 ** 31 or n >= 2 ** 16:
        raise ValueError(f"padded length {lp} is shorter than n_fft, or {n} "
                         "clips are too many for the kernel's indices")
    t = 1 + (lp - n_fft) // hop_length
    tables = _kernel_constants(n_fft, win_length, n_mels, sample_rate,
                               wav.device)
    if tables.fb_weights.numel() > _MAX_NNZ:
        raise ValueError(f"the filterbank has {tables.fb_weights.numel()} "
                         f"non-zeros; the kernel holds {_MAX_NNZ}")
    mel = torch.empty((n, 4, t, n_mels), dtype=torch.float32,
                      device=wav.device)
    iv = torch.empty((n, 3, t, n_mels), dtype=torch.float32,
                     device=wav.device)
    kernels.launch("foa_frontend", _library().seld_foa_frontend,
                   "foa_frontend launch", wav.get_device(), wav.data_ptr(),
                   tables.window.data_ptr(), tables.twiddles.data_ptr(),
                   tables.fb_index.data_ptr(), tables.fb_weights.data_ptr(),
                   mel.data_ptr(), iv.data_ptr(), n, lp, t, hop_length, eps)
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
    mel-projected intensity vectors (extract_features parity). The span
    `seld.score.frontend` under a profiler."""
    if wav.dim() < 2 or wav.shape[-2] != 4:
        raise ValueError("fused FOA frontend expects 4 input channels")
    with span("seld.score.frontend"):
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
