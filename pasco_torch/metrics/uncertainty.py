"""Instance- and panoptic-voxel-level uncertainty metrics (ECE / NLL).

NumPy re-implementation of ``UncertaintyMetrics`` (reference
``pasco/models/metrics.py:74-260``): per-instance confidence-vs-correctness
calibration, all-class-probability NLL against matched GT classes, and
panoptic-voxel ECE over GT-matched segment ids.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from pasco_torch.metrics.ssc import binary_calibration_error


class UncertaintyMetrics:
    def __init__(self):
        self.reset()

    def reset(self):
        self.ins_confs: List[float] = []
        self.ins_correct: List[bool] = []
        self.ins_all_class_probs: List[np.ndarray] = []
        self.ins_sem_labels: List[int] = []
        self.mask_ece = 0.0
        self.count = 0

    def compute_ece_panop(
        self,
        pred_panoptic_seg: np.ndarray,
        pred_segments_info: List[dict],
        vox_confidence_dense: np.ndarray,
        pred_gt_matched_segms: Sequence[Tuple[int, int]],
        gt_panoptic_seg: np.ndarray,
        gt_segments_info: List[dict],
        n_classes: int,
    ):
        """Reference ``compute_ece_panop`` (``metrics.py:98-165``)."""
        pred2gt = {p: g for g, p in pred_gt_matched_segms}
        gt_segments_dict = {s["id"]: s for s in gt_segments_info}

        # Per-instance calibration: confidence vs matched-and-correct.
        for seg in pred_segments_info:
            self.ins_confs.append(float(seg["confidence"]))
            pred_id = seg["id"]
            if pred_id not in pred2gt:
                correct = False
                gt_class = n_classes
            else:
                gt_seg = gt_segments_dict[pred2gt[pred_id]]
                correct = gt_seg["category_id"] == seg["category_id"]
                gt_class = gt_seg["category_id"]
            self.ins_all_class_probs.append(
                np.asarray(seg["all_class_probs"], np.float64)
            )
            self.ins_sem_labels.append(int(gt_class))
            self.ins_correct.append(bool(correct))

        # Panoptic-voxel ECE: map pred segment ids onto matched gt ids.
        mapped = np.zeros_like(gt_panoptic_seg)
        for gt_id, pred_id in pred_gt_matched_segms:
            mapped[pred_panoptic_seg == pred_id] = gt_id
        nonempty = (gt_panoptic_seg != 0) & (vox_confidence_dense != 0)
        correct_vox = mapped[nonempty] == gt_panoptic_seg[nonempty]
        self.mask_ece += binary_calibration_error(
            vox_confidence_dense[nonempty], correct_vox
        )
        self.count += 1

    def get_stats(self) -> Dict[str, float]:
        mask_ece = self.mask_ece / self.count if self.count else 0.0
        if self.ins_all_class_probs:
            probs = np.stack(self.ins_all_class_probs)      # [M, C+1]
            labels = np.asarray(self.ins_sem_labels, np.int64)
            labels = np.clip(labels, 0, probs.shape[1] - 1)
            nll = float(
                np.mean(-np.log(probs[np.arange(len(labels)), labels] + 1e-8))
            )
            brier = brier_score(probs, labels)
        else:
            nll = 0.0
            brier = 0.0
        ins_ece = (
            binary_calibration_error(
                np.asarray(self.ins_confs), np.asarray(self.ins_correct)
            )
            if self.ins_confs
            else 0.0
        )
        fpr95 = (
            fpr_at_95_tpr(
                np.asarray(self.ins_confs), np.asarray(self.ins_correct)
            )
            if self.ins_confs
            else 0.0
        )
        return {
            "mask_ece": mask_ece,
            "ins_ece": ins_ece,
            "ins_nll": nll,
            "ins_brier": brier,
            "ins_fpr95": fpr95,
            "count": len(self.ins_confs),
        }


def brier_score(probs: np.ndarray, targets: np.ndarray) -> float:
    """Multi-class Brier score (reference ``BrierScore``,
    ``metrics.py:259-371``): mean squared distance between the predicted
    distribution and the one-hot target."""
    probs = np.asarray(probs, np.float64)
    t = np.zeros_like(probs)
    t[np.arange(len(targets)), np.asarray(targets, np.int64)] = 1.0
    return float(np.mean(np.sum((probs - t) ** 2, axis=-1)))


def fpr_at_95_tpr(confidences: np.ndarray, correct: np.ndarray) -> float:
    """FPR@95TPR over (confidence, correctness) pairs (reference ``FPR95``,
    ``metrics.py:374-447``)."""
    conf = np.asarray(confidences, np.float64)
    pos = np.asarray(correct, bool)
    if pos.sum() == 0 or (~pos).sum() == 0:
        return 0.0
    order = np.argsort(-conf)
    pos_sorted = pos[order]
    tpr = np.cumsum(pos_sorted) / pos.sum()
    fpr = np.cumsum(~pos_sorted) / (~pos).sum()
    idx = np.searchsorted(tpr, 0.95)
    idx = min(idx, len(fpr) - 1)
    return float(fpr[idx])
