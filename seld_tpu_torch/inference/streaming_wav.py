"""Live-audio streaming: raw samples -> the front-end -> StreamingSELD
(seld_tpu/inference/streaming_wav.py).

Push raw multichannel PCM or float samples as they arrive and receive final
SELD label frames. The front-end (centered STFT, reflect padding, mel and
intensity vectors, or GCC-PHAT in mode "mic"; ops/features.py) is itself
streamed with the same
three-phase pattern as the trunk:

  - feature frame t reads samples [t*hop - n_fft//2, t*hop + n_fft//2), so
    a frame is exact once computed >= `hf = ceil((n_fft//2)/hop)` frames
    from a segment edge (no reflect-pad involvement);
  - the FIRST segment is clip-aligned (the left reflect pad lands on the
    true clip start) and the tail segment is right-aligned (the true clip
    end);
  - one `extract_features` call per device step, on the engine's device:
    on the card one launch of the front-end kernel where
    `frontend_applicable` holds (64 mels, n_fft 1024; mode "foa"), else the
    plain composition there.

The front-end's top-dB floor (max - 80 dB) is taken over each extraction,
as the JAX package takes it: streamed frames equal the offline ones where
no segment spans more than 80 dB of power (noise does not; a clip with a
stretch of digital silence can), and differ from them where one does.

Emitted frames equal the offline pipeline otherwise: extract_features on
the whole clip, cropped to a multiple of the label multiplier, normalized,
then `ensemble_outputs(fast=True)`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from seld_tpu_torch.inference.ensemble import _model_device
from seld_tpu_torch.inference.streaming import StreamingSELD
from seld_tpu_torch.ops.features import FEATURE_CHANNELS, extract_features


class StreamingFrontEnd:
    """Incremental wav -> feature-frame extraction (push/finalize API).

    push(samples [chan, n]) -> [k, n_mels, C] newly-final feature frames;
    finalize() -> the remaining frames. Total frames over a clip of T
    samples (T % hop == 0) = T // hop + 1, identical to the offline
    centered STFT. Extraction runs on `device` ("cuda" unless the caller
    asks for "cpu"); frames come back as host arrays.
    """

    def __init__(self, *, mode: str = "foa", sample_rate: int = 24000,
                 n_mels: int = 64, n_fft: int = 1024, win_length: int = 960,
                 hop_length: int = 480, chunk_frames: int = 50,
                 device="cuda"):
        if mode not in FEATURE_CHANNELS:
            raise ValueError(f"invalid mode: {mode!r}")
        self.kw = dict(mode=mode, sample_rate=sample_rate, n_mels=n_mels,
                       n_fft=n_fft, win_length=win_length,
                       hop_length=hop_length)
        self.device = torch.device(device)
        self.hop = hop_length
        self.hf = -(-(n_fft // 2) // hop_length)  # frames tainted per edge
        self.chunk_f = chunk_frames
        self.chunk_s = chunk_frames * hop_length
        self.l_s = (self.chunk_f + 2 * self.hf) * hop_length
        self.reset()

    def _extract(self, segment: np.ndarray) -> np.ndarray:
        wav = torch.from_numpy(np.ascontiguousarray(segment)).to(self.device)
        with torch.inference_mode():
            return extract_features(wav, **self.kw).cpu().numpy()

    def push(self, samples: np.ndarray):
        """samples: [chan, n] float in [-1, 1) (or signed int PCM)."""
        samples = np.asarray(samples)
        if samples.dtype.kind == "u":
            raise ValueError(
                f"unsigned PCM ({samples.dtype}) is not supported — "
                "convert to signed PCM or float first (8-bit wav data is "
                "offset-binary, which a plain scale would silently corrupt)")
        scale = (float(2 ** (8 * samples.dtype.itemsize - 1))
                 if samples.dtype.kind == "i" else None)
        samples = samples.astype(np.float32)  # every block, one copy
        if scale is not None:
            samples /= scale
        if self._pending is None:
            self._pending = samples
        else:
            self._pending = np.concatenate([self._pending, samples], axis=1)
        self._fed_s += samples.shape[1]
        out = []
        if self._e == 0:
            if self._pending.shape[1] < self.l_s:
                return out
            # bootstrap: clip-aligned segment; the left reflect pad is the
            # true clip edge. Settle frames [0, chunk_f + hf).
            seg = self._pending[:, :self.l_s]
            feats = self._extract(seg)
            out.append(feats[:self.chunk_f + self.hf])
            self._e = self.l_s
            self._buf = seg
            self._pending = self._pending[:, self.l_s:]
        while self._pending.shape[1] >= self.chunk_s:
            chunk, self._pending = (self._pending[:, :self.chunk_s],
                                    self._pending[:, self.chunk_s:])
            self._buf = np.concatenate(
                [self._buf[:, self.chunk_s:], chunk], axis=1)
            feats = self._extract(self._buf)
            # frames [hf, hf + chunk_f) of the segment are pad-free and
            # >= hf from both edges -> exact
            out.append(feats[self.hf: self.hf + self.chunk_f])
            self._e += self.chunk_s
        return list(np.concatenate(out)) if out else []

    def finalize(self):
        """Right-aligned tail; returns the remaining frames (total
        T // hop + 1)."""
        if self._fed_s == 0:
            raise ValueError("no samples fed before finalize()")
        if self._pending is None:
            raise ValueError("already finalized; reset() starts a new clip")
        if self._fed_s % self.hop:
            raise ValueError(
                f"total samples ({self._fed_s}) must be a multiple of the "
                f"hop ({self.hop})")
        n_total = self._fed_s // self.hop + 1
        if self._e == 0:
            # short clip: one clip-aligned extraction (clear _pending only
            # on success so a failed finalize stays retryable)
            feats = self._extract(self._pending)
            self._pending = None
            return list(feats[:n_total])
        emitted = self._e // self.hop - self.hf   # settled frame count
        tail = np.concatenate([self._buf, self._pending], axis=1)
        tail = tail[:, tail.shape[1] - self.l_s:]  # last l_s real samples
        feats = self._extract(tail)
        self._pending = None
        # absolute frame t is segment frame t - (fed_s - l_s)/hop
        k0 = emitted - (self._fed_s - self.l_s) // self.hop
        return list(feats[k0: k0 + (n_total - emitted)])

    def reset(self):
        self._pending = None
        self._buf = None
        self._e = 0        # samples consumed into settled segments
        self._fed_s = 0


class StreamingSELDWav:
    """Raw audio in, SELD events out — live.

    Composes StreamingFrontEnd -> normalizer -> StreamingSELD, both on the
    model's device. The frame count is cropped to a multiple of the label
    multiplier (the offline preprocess_features_labels crop), so emitted
    label frames match `make_answer`-style offline inference of the same
    clip.

    >>> sw = StreamingSELDWav(model, normalizer=(mean, std))
    >>> for block in microphone:               # [4, n] samples
    ...     events.extend(sw.push(block))
    >>> events.extend(sw.finalize())
    """

    def __init__(self, model: nn.Module,
                 normalizer: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 *, mode: str = "foa", sample_rate: int = 24000,
                 n_mels: int = 64, n_fft: int = 1024, win_length: int = 960,
                 hop_length: int = 480, win_size: int = 300,
                 time_down: int = 5, chunk: int = 10, halo=None, dtype=None):
        self.frontend = StreamingFrontEnd(
            mode=mode, sample_rate=sample_rate, n_mels=n_mels, n_fft=n_fft,
            win_length=win_length, hop_length=hop_length,
            chunk_frames=chunk * time_down,
            device=_model_device(model, None))
        # 4 log-mel + 3 intensity-vector (foa) or 6 GCC-PHAT (mic) channels
        self.seld = StreamingSELD(
            model, feat_shape=(n_mels, FEATURE_CHANNELS[mode]), win_size=win_size,
            step_size=time_down, time_down=time_down, chunk=chunk,
            halo=halo, dtype=dtype)
        self.multiplier = time_down
        if normalizer is not None:
            self.mean = np.asarray(normalizer[0], np.float32)
            self.std = np.asarray(normalizer[1], np.float32)
        else:
            self.mean = self.std = None
        self._frame_carry = None

    def _normalize(self, feats: np.ndarray) -> np.ndarray:
        if self.mean is None:
            return feats
        return (feats - self.mean) / self.std

    def _feed(self, frames, last: bool):
        """Buffer frames to multiplier alignment; on the last feed, CROP
        the remainder (the offline preprocess crop)."""
        if not len(frames):
            frames = np.zeros((0, *self.seld.feat_shape), np.float32)
        else:
            frames = np.asarray(frames)
        if self._frame_carry is not None:
            frames = np.concatenate([self._frame_carry, frames])
        keep = (frames.shape[0] // self.multiplier) * self.multiplier
        self._frame_carry = None if last else frames[keep:]
        return frames[:keep]

    def push(self, samples: np.ndarray):
        frames = self._feed(self.frontend.push(samples), last=False)
        if not frames.shape[0]:
            return []
        return self.seld.push(self._normalize(frames))

    def finalize(self):
        frames = self._feed(self.frontend.finalize(), last=True)
        out = []
        if frames.shape[0]:
            out = self.seld.push(self._normalize(frames))
        return out + self.seld.finalize()

    def reset(self):
        self.frontend.reset()
        self.seld.reset()
        self._frame_carry = None
