"""Official DCASE2021 segment-level SELD scorer (host-side numpy).

Numerically-identical reimplementation of the official evaluator the
reference vendors (SELD_evaluation_metrics.py:18-154; MIT): 1-second segment
metrics with Hungarian assignment of predicted-to-reference DOA tracks and
the multi-instance extension. Kept host-side and exact — this is the scorer
used for checkpoint selection; the jittable streaming metrics
(seld_tpu_torch.train.metrics) give fast in-step feedback.

Differences from the vendored original: structured as small pure functions,
`np.finfo(np.float)` modernized (broken on numpy>=1.24), no behavioral change.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

_EPS = np.finfo(np.float64).eps


def spherical_distance_rad(az1, ele1, az2, ele2) -> np.ndarray:
    """Great-circle distance (degrees) between spherical coords in radians."""
    cos_d = (np.sin(ele1) * np.sin(ele2)
             + np.cos(ele1) * np.cos(ele2) * np.cos(np.abs(az1 - az2)))
    return np.degrees(np.arccos(np.clip(cos_d, -1.0, 1.0)))


def cartesian_distance(x1, y1, z1, x2, y2, z2) -> np.ndarray:
    """Great-circle distance (degrees) between cartesian DOA vectors."""
    n1 = np.sqrt(x1 ** 2 + y1 ** 2 + z1 ** 2 + 1e-10)
    n2 = np.sqrt(x2 ** 2 + y2 ** 2 + z2 ** 2 + 1e-10)
    cos_d = (x1 * x2 + y1 * y2 + z1 * z2) / (n1 * n2)
    return np.degrees(np.arccos(np.clip(cos_d, -1.0, 1.0)))


def least_distance_between_gt_pred(gt_list: np.ndarray, pred_list: np.ndarray
                                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hungarian-matched distances between two DOA sets ([N, 2] rad or [N, 3])."""
    gt_len, pred_len = gt_list.shape[0], pred_list.shape[0]
    cost = np.zeros((gt_len, pred_len))
    if gt_len and pred_len:
        gt_b = gt_list[:, None, :]
        pr_b = pred_list[None, :, :]
        if gt_list.shape[-1] == 3:
            cost = cartesian_distance(
                gt_b[..., 0], gt_b[..., 1], gt_b[..., 2],
                pr_b[..., 0], pr_b[..., 1], pr_b[..., 2])
        else:
            cost = spherical_distance_rad(
                gt_b[..., 0], gt_b[..., 1], pr_b[..., 0], pr_b[..., 1])
    row_ind, col_ind = linear_sum_assignment(cost)
    return cost[row_ind, col_ind], row_ind, col_ind


class SELDMetricsOfficial:
    """Accumulates official segment-level scores over clips.

    Inputs are segment dicts produced by `seld_tpu_torch.utils.io.segment_labels`:
      {block: {class: [[frame_keys, [[doa..., track] per frame]]]}}
    with DOAs either cartesian (3 values) or polar degrees (2 values).
    """

    def __init__(self, doa_threshold: float = 20, nb_classes: int = 11):
        self._nb_classes = nb_classes
        self._spatial_T = doa_threshold
        self._TP = 0
        self._FP = 0
        self._FN = 0
        self._S = 0
        self._D = 0
        self._I = 0
        self._Nref = 0
        self._total_DE = 0.0
        self._DE_TP = 0
        self._DE_FP = 0
        self._DE_FN = 0

    # -- scoring ----------------------------------------------------------
    def compute_seld_scores(self) -> Tuple[float, float, float, float]:
        ER = (self._S + self._D + self._I) / float(self._Nref + _EPS)
        F = self._TP / (_EPS + self._TP + 0.5 * (self._FP + self._FN))
        LE = (self._total_DE / float(self._DE_TP + _EPS)
              if self._DE_TP else 180.0)
        LR = self._DE_TP / (_EPS + self._DE_TP + self._DE_FN)
        return ER, F, LE, LR

    def early_stopping_metric(self) -> float:
        ER, F, LE, LR = self.compute_seld_scores()
        return float(np.mean([ER, 1 - F, LE / 180.0, 1 - LR]))

    # -- accumulation -----------------------------------------------------
    def _match_tracks(self, gt_entry, pred_entry) -> Dict[float, List[float]]:
        """Frame-wise Hungarian matching; returns {gt_track_id: [distances]}."""
        matched: Dict[float, List[float]] = {}
        gt_frames, gt_values = gt_entry[0][0], gt_entry[0][1]
        pred_frames, pred_values = pred_entry[0][0], pred_entry[0][1]
        for gt_ind, frame in enumerate(gt_frames):
            if frame not in pred_frames:
                continue
            gt_arr = np.array(gt_values[gt_ind])
            gt_ids = gt_arr[:, -1]
            gt_doas = gt_arr[:, :-1]
            pred_arr = np.array(pred_values[pred_frames.index(frame)])
            pred_doas = pred_arr[:, :-1]
            if gt_doas.shape[-1] == 2:  # polar degrees -> radians
                gt_doas = gt_doas * np.pi / 180.0
                pred_doas = pred_doas * np.pi / 180.0
            dists, rows, _ = least_distance_between_gt_pred(gt_doas, pred_doas)
            for cnt, dist in enumerate(dists):
                track = gt_ids[rows[cnt]]
                matched.setdefault(track, []).append(dist)
        return matched

    def update_seld_scores(self, pred: dict, gt: dict) -> None:
        for block_cnt in range(len(gt.keys())):
            loc_FN, loc_FP = 0, 0
            for class_cnt in range(self._nb_classes):
                in_gt = class_cnt in gt[block_cnt]
                in_pred = class_cnt in pred[block_cnt]

                if in_gt:
                    self._Nref += max(
                        len(val) for val in gt[block_cnt][class_cnt][0][1])

                if in_gt and in_pred:
                    matched = self._match_tracks(gt[block_cnt][class_cnt],
                                                 pred[block_cnt][class_cnt])
                    if not matched:
                        # predictions never align frame-wise with the reference
                        loc_FN += 1
                        self._FN += 1
                        self._DE_FN += 1
                    else:
                        for dists in matched.values():
                            avg_dist = sum(dists) / len(dists)
                            self._total_DE += avg_dist
                            self._DE_TP += 1
                            if avg_dist <= self._spatial_T:
                                self._TP += 1
                            else:
                                loc_FP += 1
                                self._FP += 1
                elif in_gt:
                    loc_FN += 1
                    self._FN += 1
                    self._DE_FN += 1
                elif in_pred:
                    loc_FP += 1
                    self._FP += 1
                    self._DE_FP += 1

            self._S += np.minimum(loc_FP, loc_FN)
            self._D += np.maximum(0, loc_FN - loc_FP)
            self._I += np.maximum(0, loc_FP - loc_FN)


def early_stopping_metric(sed_error, doa_error) -> float:
    """SELD score from (ER, F) + (LE, LR) (SELD_evaluation_metrics.py:223-237)."""
    return float(np.mean([sed_error[0], 1 - sed_error[1],
                          doa_error[0] / 180.0, 1 - doa_error[1]]))
