"""VAD training (seld_tpu/train/vad.py; reference train_vad_baseline.py).

Keras `model.fit` with AUC-monitored early stopping becomes an explicit
step loop: BCE loss (plus the pipe net's auxiliary BCE for the attention
model), AdaBelief at a settable learning rate, best-parameter restore on
val AUC, and full-sequence evaluation through the overlap reconstruction
(seq_to_windows / windows_to_seq).

The model lives on `device` (the card unless the caller asks for the CPU);
batches arrive as numpy and are copied there. A train epoch's losses stay
on the device and are read once, after the epoch. Dropout masks come from
the `TrainState`'s generator; they cannot match the JAX package's, so
parity holds at dropout 0 or in eval mode.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from seld_tpu_torch.data.vad import (preprocess_window, seq_to_windows,
                                     windows_to_seq)
from seld_tpu_torch.models import build_model
from seld_tpu_torch.train import losses as L
from seld_tpu_torch.train.optimizers import adabelief
from seld_tpu_torch.train.train_state import TrainState


def binary_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based ROC AUC (host-side; tf.keras.metrics.AUC parity target)."""
    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores).reshape(-1)
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    from scipy.stats import rankdata
    ranks = rankdata(scores)  # average ranks under ties
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def binary_metrics(labels, scores, threshold: float = 0.5) -> Dict[str, float]:
    labels = np.asarray(labels).reshape(-1) > 0.5
    preds = np.asarray(scores).reshape(-1) > threshold
    tp = float((labels & preds).sum())
    fp = float((~labels & preds).sum())
    fn = float((labels & ~preds).sum())
    acc = float((labels == preds).mean())
    precision = tp / max(tp + fp, 1e-8)
    recall = tp / max(tp + fn, 1e-8)
    f1 = 2 * precision * recall / max(precision + recall, 1e-8)
    return {"binary_accuracy": acc, "precision": precision,
            "recall": recall, "f1": f1}


class VADTrainer:
    """`weights`: an optional state_dict to start from (e.g. the JAX
    package's initial variables through seld_tpu_torch.bridge.from_flax);
    else the port's seeded initialisation."""

    def __init__(self, model_config: dict, input_shape,
                 model_name: str = "vad_architecture",
                 lr: float = 1e-4, seed: int = 0, device=None,
                 weights: Optional[Dict[str, torch.Tensor]] = None):
        self.device = torch.device(device if device is not None else "cuda")
        self.model = build_model(model_name, input_shape, model_config,
                                 seed=seed, device=self.device)
        if weights is not None:
            self.model.load_state_dict(weights)
        self.model_name = model_name
        self.state = TrainState(
            self.model, adabelief(list(self.model.parameters()), lr),
            seed=seed + 1)
        self._multi_output = \
            model_name == "spectro_temporal_attention_based_VAD"

    def _batch(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One update in place; returns the loss as a device tensor."""
        model = self.model.train()
        params = list(model.parameters())
        with torch.enable_grad():
            out = model(x)
            pred = out[0][..., 0] if self._multi_output else out
            loss = L.binary_crossentropy(y, pred).mean()
            if self._multi_output:  # auxiliary pipe-net loss (models.py:131)
                loss = loss + L.binary_crossentropy(y, out[1][..., 0]).mean()
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        self.state.optimizer.step(params, grads)
        self.state.step += 1
        return loss.detach()

    @torch.no_grad()
    def predict_step(self, x: torch.Tensor) -> torch.Tensor:
        out = self.model.eval()(x)
        return out[0][..., 0] if self._multi_output else out

    def evaluate(self, dataset) -> Dict[str, float]:
        labels, scores = [], []
        for x, y in dataset:
            labels.append(np.asarray(y).reshape(-1))
            scores.append(self.predict_step(self._batch(x)))
        labels = np.concatenate(labels)
        scores = torch.cat([s.reshape(-1) for s in scores]).cpu().numpy()
        return {"auc": binary_auc(labels, scores),
                **binary_metrics(labels, scores)}

    def fit(self, trainset, valset=None, epochs: int = 1,
            patience: int = 16, verbose: bool = True) -> Dict:
        """As the JAX trainer: the best val AUC's parameters are restored
        at the end (the running statistics stay the last epoch's)."""
        def snapshot():
            return {k: p.detach().clone()
                    for k, p in self.model.named_parameters()}

        best_auc = -np.inf
        best_params = snapshot()
        wait = 0
        history = []
        for epoch in range(epochs):
            losses = []
            for x, y in trainset:
                losses.append(self.train_step(self._batch(x),
                                              self._batch(y)))
            # one read an epoch; the mean in f64, as of the JAX trainer's floats
            losses = torch.stack(losses).cpu().numpy().astype(np.float64)
            record = {"epoch": epoch, "loss": float(np.mean(losses))}
            if valset is not None:
                val = self.evaluate(valset)
                record.update({f"val_{k}": v for k, v in val.items()})
                if val["auc"] > best_auc:
                    best_auc = val["auc"]
                    best_params = snapshot()
                    wait = 0
                else:
                    wait += 1
            history.append(record)
            if verbose:
                print(record)
            # keras EarlyStopping parity: stop AFTER `patience`
            # non-improving epochs, not patience+1
            if valset is not None and wait >= patience:
                break
        if valset is not None:
            with torch.no_grad():
                for k, p in self.model.named_parameters():
                    p.copy_(best_params[k])
        return {"history": history, "best_val_auc": best_auc}

    def evaluate_sequences(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                           window, batch_size: int = 256) -> Dict[str, float]:
        """Full-sequence eval via window overlap reconstruction
        (train_vad_baseline.py:206-227)."""
        window = preprocess_window(window)
        width = int(window.max())
        labels, scores = [], []
        for feat, label in pairs:
            if len(label) <= width:  # shorter than the context window
                continue
            fw = seq_to_windows(np.asarray(feat, np.float32), window)
            preds = [self.predict_step(self._batch(fw[i:i + batch_size]))
                     for i in range(0, len(fw), batch_size)]
            preds = torch.cat(preds).cpu().numpy()      # [n_win, win_size]
            seq_pred = windows_to_seq(preds[..., None], window)[..., 0]
            # truncate BOTH ways: feat/label length mismatches otherwise
            # concatenate ragged arrays and crash (or misalign) in the AUC
            n = min(len(seq_pred), len(label))
            labels.append(np.asarray(label)[:n])
            scores.append(seq_pred[:n])
        labels = np.concatenate(labels)
        scores = np.concatenate(scores)
        return {"auc": binary_auc(labels, scores),
                **binary_metrics(labels, scores)}
