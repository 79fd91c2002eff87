"""Streaming SELD metrics as a dict of tensors (seld_tpu/train/metrics.py).

The block dimension is folded into the batch, so one update is a few
vector ops on the device and nothing leaves it during an epoch. State is a
plain dict of scalars / [C] tensors; `merge` adds two states, and
`update_global` adds the global batch's sums inside a data-parallel step
(one all-reduce of this rank's).

Semantics per block (reference metrics.py:77-154):
  detection  : class-in-block presence; ER from S/D/I counts
  location   : TP when the class matches and the mean angular error over
               matched frames is <= doa_threshold (20 deg)
  class-wise : per-class tp/fp/tn/fn for recall/precision
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

State = Dict[str, torch.Tensor]

_SCALARS = ("TP", "FP", "TN", "FN", "S", "D", "I", "Nref", "Nsys",
            "total_DE", "DE_TP")
_CLASS_ARRAYS = ("class_tp", "class_fp", "class_tn", "class_fn")


def init_state(n_classes: int = 14, device="cuda") -> State:
    state = {k: torch.zeros((), device=device) for k in _SCALARS}
    state.update({k: torch.zeros(n_classes, device=device)
                  for k in _CLASS_ARRAYS})
    return state


def merge(a: State, b: State) -> State:
    return {k: a[k] + b[k] for k in a}


def all_reduce_(state: State) -> State:
    """Sum every rank's state into each rank's, in place, as one all-reduce
    of the flattened sums over the active step's batch (JAX's psum of the
    state over the data axis)."""
    from seld_tpu_torch.parallel import collectives
    flat = collectives.batch_reduce_(
        torch.cat([v.reshape(-1) for v in state.values()]))
    for v, part in zip(state.values(),
                       flat.split([v.numel() for v in state.values()])):
        v.copy_(part.view_as(v))
    return state


def update_global(state: State, y_true, y_pred, **kw) -> State:
    """`update` with this rank's batch inside a data-parallel step
    (parallel/collectives.py): the batch's sums are all-reduced before they
    are added, so every rank holds the global batch's state (a rank that
    replicates another's rows adds zeros). Outside one, `update` itself."""
    from seld_tpu_torch.parallel import collectives
    if collectives.active() is None:
        return update(state, y_true, y_pred, **kw)
    zeros = {k: torch.zeros_like(v) for k, v in state.items()}
    mine = update(zeros, y_true, y_pred, **kw) if collectives.primary() \
        else zeros
    return merge(state, all_reduce_(mine))


def distance_between_cartesian_coordinates(xyz0: torch.Tensor,
                                           xyz1: torch.Tensor
                                           ) -> torch.Tensor:
    """Great-circle distance in degrees over the last axis; zero where both
    vectors are all-zero (unmatched frames)."""
    xyz0 = xyz0 / xyz0.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    xyz1 = xyz1 / xyz1.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    zeros = (xyz0.sum(dim=-1) == 0) & (xyz1.sum(dim=-1) == 0)
    dist = torch.clamp((xyz0 * xyz1).sum(dim=-1), -1.0, 1.0)
    dist = torch.rad2deg(torch.arccos(dist))
    return dist * (1.0 - zeros.to(dist.dtype))


def _safe_div(x, y, eps=1e-8):
    return x / torch.clamp_min(y, eps)


def update(state: State,
           y_true: Tuple[torch.Tensor, torch.Tensor],
           y_pred: Tuple[torch.Tensor, torch.Tensor],
           doa_threshold: float = 20.0,
           block_size: int = 10,
           sed_threshold=0.5) -> State:
    """Accumulate one batch. sed [B, T, C], doa [B, T, 3C];
    T % block_size == 0. sed_threshold may be a float or a tensor."""
    sed_true, doa_true = y_true
    sed_pred, doa_pred = y_pred
    if sed_true.dim() == 2:
        sed_true, doa_true = sed_true[None], doa_true[None]
        sed_pred, doa_pred = sed_pred[None], doa_pred[None]

    b, t, c = sed_true.shape
    if t % block_size != 0:
        raise ValueError(f"time {t} not divisible by block size {block_size}")
    nb = t // block_size
    n = b * nb

    sed_true = sed_true.reshape(n, block_size, c).float()
    sed_pred = (sed_pred.reshape(n, block_size, c) > sed_threshold).float()
    # [N, block, 3C] -> [N, block, C, 3]
    doa_true = doa_true.reshape(n, block_size, 3, c).transpose(-1, -2)
    doa_pred = doa_pred.reshape(n, block_size, 3, c).transpose(-1, -2)

    true_classes = sed_true.amax(dim=-2, keepdim=True)        # [N, 1, C]
    pred_classes = sed_pred.amax(dim=-2, keepdim=True)

    out = dict(state)
    out["Nref"] = state["Nref"] + true_classes.sum()
    out["Nsys"] = state["Nsys"] + pred_classes.sum()
    out["TN"] = state["TN"] + ((1 - true_classes) * (1 - pred_classes)).sum()

    false_negative = true_classes * (1 - pred_classes)
    false_positive = (1 - true_classes) * pred_classes
    true_negative = (1 - true_classes) * (1 - pred_classes)
    true_positives = true_classes * pred_classes

    out["class_fn"] = state["class_fn"] + false_negative.sum(dim=(-3, -2))
    out["class_fp"] = state["class_fp"] + false_positive.sum(dim=(-3, -2))
    out["class_tn"] = state["class_tn"] + true_negative.sum(dim=(-3, -2))
    out["class_tp"] = state["class_tp"] + true_positives.sum(dim=(-3, -2))

    fn = false_negative.sum()
    fp = false_positive.sum()
    loc_fn = false_negative.sum(dim=(-2, -1))                   # [N]
    loc_fp = false_positive.sum(dim=(-2, -1))

    # classes present in both: frame-level matching
    frames_matched = (sed_true * true_positives) * (sed_pred * true_positives)
    total_matched = frames_matched.sum(dim=-2, keepdim=True)    # [N, 1, C]
    matched_exist = (total_matched > 0).float()
    out["DE_TP"] = state["DE_TP"] + matched_exist.sum()

    fn2 = true_positives * (1 - matched_exist)
    fn = fn + fn2.sum()
    loc_fn = loc_fn + fn2.sum(dim=(-2, -1))

    distances = distance_between_cartesian_coordinates(
        doa_true * frames_matched[..., None],
        doa_pred * frames_matched[..., None])                   # [N, block, C]
    avg_distances = _safe_div(distances.sum(dim=-2, keepdim=True),
                              total_matched)
    out["total_DE"] = state["total_DE"] + avg_distances.sum()

    close = (avg_distances <= doa_threshold).float()
    out["TP"] = state["TP"] + (close * matched_exist).sum()

    fn3 = (1 - close) * matched_exist
    fn = fn + fn3.sum()
    loc_fn = loc_fn + fn3.sum(dim=(-2, -1))

    out["FN"] = state["FN"] + fn
    out["FP"] = state["FP"] + fp
    out["S"] = state["S"] + torch.minimum(loc_fp, loc_fn).sum()
    out["D"] = state["D"] + (loc_fn - loc_fp).clamp_min(0).sum()
    out["I"] = state["I"] + (loc_fp - loc_fn).clamp_min(0).sum()
    return out


def result(state: State):
    """(ER, F, DE, DE_F) — reference metrics.py:34-53."""
    er = _safe_div(state["S"] + state["D"] + state["I"], state["Nref"])
    prec = _safe_div(state["TP"], state["TP"] + state["FP"])
    recall = _safe_div(state["TP"], state["TP"] + state["FN"])
    f = _safe_div(2 * prec * recall, prec + recall)
    de = torch.where(state["DE_TP"] > 0,
                     _safe_div(state["total_DE"], state["DE_TP"]),
                     torch.full_like(state["DE_TP"], 180.0))
    de_prec = _safe_div(state["DE_TP"], state["Nsys"])
    de_recall = _safe_div(state["DE_TP"], state["Nref"])
    de_f = _safe_div(2 * de_prec * de_recall, de_prec + de_recall)
    return er, f, de, de_f


def class_result(state: State):
    recall = _safe_div(state["class_tp"],
                       state["class_tp"] + state["class_fn"])
    precision = _safe_div(state["class_tp"],
                          state["class_tp"] + state["class_fp"])
    return recall, precision


def calculate_seld_score(metric_values):
    """(ER + (1 - F) + LE/180 + (1 - LR)) / 4 (reference metrics.py:157-170)."""
    error_rate, f_score, doa_error, recall = metric_values
    return (error_rate + 1 - f_score + doa_error / 180.0 + 1 - recall) / 4


class SELDMetrics:
    """Stateful convenience wrapper mirroring the reference class API."""

    def __init__(self, doa_threshold: float = 20, block_size: int = 10,
                 n_classes: int = 14, device="cuda"):
        self.doa_threshold = doa_threshold
        self.block_size = block_size
        self.n_classes = n_classes
        self.device = device
        self.reset_states()

    def reset_states(self):
        self.state = init_state(self.n_classes, self.device)

    def update_states(self, y_true, y_pred):
        self.state = update(self.state, y_true, y_pred,
                            doa_threshold=self.doa_threshold,
                            block_size=self.block_size)

    def result(self):
        return result(self.state)

    def class_result(self):
        return class_result(self.state)
