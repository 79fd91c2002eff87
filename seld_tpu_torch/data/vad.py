"""VAD data pipeline (seld_tpu/data/vad.py; reference vad_dataloader.py).

wav -> 80-mel log spectrogram, min-max normalized to [0, 1]
(vad_dataloader.py:77-98); frame-level labels framed to STFT hops and
rounded (:101-106); 7-frame context windows [-19,-10,-1,0,1,10,19] sampled
at random offsets for training (:118-136); full-sequence overlap
reconstruction (train_vad_baseline.py:76-106) for evaluation.

The STFT here is uncentered with hop = n_fft // 2 (tf.signal.stft parity),
composed from the port's ops/stft.py and ops/mel.py on the wav's device:
the FOA front-end kernel computes another function (log-mel + IV at 64
mels), so this path launches no kernel of the port. Windowing and
`VadDataset` are numpy, with the JAX package's RandomState draws, so its
batches equal the JAX package's exactly.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from seld_tpu_torch.ops.mel import mel_filterbank
from seld_tpu_torch.ops.stft import stft

DEFAULT_WINDOW = [-19, -10, -1, 0, 1, 10, 19]


def preprocess_window(window) -> np.ndarray:
    """Shift window offsets to start at 0 (vad_dataloader.py:118-123)."""
    if isinstance(window, int):
        window = np.arange(window)
    window = np.asarray(window, np.int32)
    return window - window.min()


def vad_features_from_wav(wav: torch.Tensor, n_fft: int = 1024,
                          n_mels: int = 80, sr: int = 16000,
                          logmel: bool = True, normalize: bool = True
                          ) -> torch.Tensor:
    """[chan, T] wav (a tensor, on any device) -> [frames, n_mels, chan]
    normalized log-mel, on the wav's device."""
    spec = stft(wav, n_fft=n_fft, hop_length=n_fft // 2,
                center=False).abs()     # [chan, frames, bins]
    fbank = mel_filterbank(n_fft // 2 + 1, n_mels, sr, device=wav.device)
    spec = torch.einsum("ctf,fm->tmc", spec, fbank)
    if logmel:
        spec = torch.log(torch.clamp_min(spec, 1e-8))
    if normalize:
        lo, hi = spec.min(), spec.max()
        spec = (spec - lo) / torch.clamp_min(hi - lo, 1e-12)
    return spec


def vad_labels_from_samples(labels: np.ndarray, n_fft: int = 1024
                            ) -> np.ndarray:
    """Sample-level 0/1 labels -> frame labels (mean over frame, rounded)."""
    hop = n_fft // 2
    n_frames = 1 + (len(labels) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.round(labels[idx].mean(-1)).astype(np.float32)


def seq_to_windows(seq: np.ndarray, window) -> np.ndarray:
    """[T, ...] -> [T - max(window), len(window), ...]
    (train_vad_baseline.py:76-87)."""
    window = preprocess_window(window)
    width = int(window.max())
    parts = []
    for w in window.tolist():
        if w == width:
            parts.append(seq[width:])
        else:
            parts.append(seq[w:len(seq) - width + w])
    return np.stack(parts, axis=1)


def windows_to_seq(windows: np.ndarray, window) -> np.ndarray:
    """Inverse of seq_to_windows: overlap-average window predictions back to
    a sequence (train_vad_baseline.py:89-106)."""
    window = preprocess_window(window)
    width = int(window.max())
    total_len = windows.shape[0] + width

    seq = np.zeros((total_len, *windows.shape[2:]), windows.dtype)
    counts = np.zeros((total_len, *windows.shape[2:]), windows.dtype)
    for i, w in enumerate(window.tolist()):
        seq[w:w + windows.shape[0]] += windows[:, i]
        counts[w:w + windows.shape[0]] += 1
    return seq / (counts + 1e-8)


class VadDataset:
    """In-memory (feat [T, M, C], label [T]) pairs with context windowing.

    train=True: one random-offset window per clip per epoch pass, repeated
    `n_repeat` times and shuffled (vad_dataloader.py:126-136 semantics).
    train=False: every valid window of every clip, in order.
    """

    def __init__(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                 window=DEFAULT_WINDOW, batch_size: int = 256,
                 train: bool = True, n_repeat: int = 1, seed: int = 0):
        self.window = preprocess_window(window)
        self.width = int(self.window.max())
        self.pairs = []
        dropped = 0
        for f, l in pairs:
            if len(l) <= self.width:  # shorter than the context window
                dropped += 1
                continue
            self.pairs.append((np.asarray(f, np.float32),
                               np.asarray(l, np.float32)))
        if dropped:
            print(f"VadDataset: dropped {dropped} clip(s) shorter than "
                  f"the {self.width + 1}-frame context window")
        if not self.pairs:
            raise ValueError("no clips long enough for the context window")
        self.batch_size = batch_size
        self.train = train
        self.n_repeat = n_repeat
        self._rng = np.random.RandomState(seed)

    def _train_samples(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = []
        for _ in range(self.n_repeat):
            order.extend(self._rng.permutation(len(self.pairs)))
        for i in order:
            feat, label = self.pairs[i]
            offset = self._rng.randint(0, len(label) - self.width)
            idx = self.window + offset
            yield feat[idx], label[idx]

    def _eval_samples(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for feat, label in self.pairs:
            fw = seq_to_windows(feat, self.window)
            lw = seq_to_windows(label, self.window)
            for i in range(len(fw)):
                yield fw[i], lw[i]

    def __iter__(self):
        gen = self._train_samples() if self.train else self._eval_samples()
        xs, ys = [], []
        for x, y in gen:
            xs.append(x)
            ys.append(y)
            if len(xs) == self.batch_size:
                yield np.stack(xs), np.stack(ys)
                xs, ys = [], []
        if xs:
            yield np.stack(xs), np.stack(ys)
