"""Semantic Scene Completion metrics (mIoU, completion IoU/P/R, voxel ECE/NLL).

Vectorised NumPy re-implementation of ``SSCMetrics`` (reference
``pasco/models/metrics.py:450-691``).  The reference loops per class and per
batch item with ``np.where``; here the confusion counts come from one
``bincount`` — identical results, orders of magnitude faster on host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def binary_calibration_error(
    confidences: np.ndarray, accuracies: np.ndarray, n_bins: int = 15
) -> float:
    """torchmetrics-style L1 ECE with equal-width bins."""
    confidences = np.asarray(confidences, np.float64).reshape(-1)
    accuracies = np.asarray(accuracies, np.float64).reshape(-1)
    if confidences.size == 0:
        return 0.0
    bins = np.clip(
        (confidences * n_bins).astype(np.int64), 0, n_bins - 1
    )
    counts = np.bincount(bins, minlength=n_bins)
    conf_sums = np.bincount(bins, weights=confidences, minlength=n_bins)
    acc_sums = np.bincount(bins, weights=accuracies, minlength=n_bins)
    nz = counts > 0
    ece = np.abs(acc_sums[nz] / counts[nz] - conf_sums[nz] / counts[nz])
    return float(np.sum(ece * counts[nz] / confidences.size))


class SSCMetrics:
    """Accumulates completion (binary) and semantic (per-class) confusion
    counts plus voxel-level calibration stats."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        self.completion_tp = 0
        self.completion_fp = 0
        self.completion_fn = 0
        self.tps = np.zeros(self.n_classes, np.int64)
        self.fps = np.zeros(self.n_classes, np.int64)
        self.fns = np.zeros(self.n_classes, np.int64)
        self.empty_ece = 0.0
        self.nonempty_ece = 0.0
        self.ece_count = 0
        self.empty_nll = 0.0
        self.nonempty_nll = 0.0
        self.n_empty_voxels = 0
        self.n_nonempty_voxels = 0
        self.inference_time = 0.0

    def add_batch(
        self,
        y_pred: np.ndarray,
        y_true: np.ndarray,
        nonempty: Optional[np.ndarray] = None,
    ):
        """Reference ``add_batch`` (``metrics.py:525-548``): voxels with
        ``y_true == 255`` (unknown) are excluded from every count."""
        y_pred = np.asarray(y_pred).reshape(-1)
        y_true = np.asarray(y_true).reshape(-1)
        mask = y_true != 255
        if nonempty is not None:
            mask &= np.asarray(nonempty, bool).reshape(-1)

        # --- completion: binary occupied-vs-empty P/R/IoU -----------------
        bp = (y_pred > 0) & mask
        bt = (y_true > 0) & mask
        self.completion_tp += int(np.sum(bp & bt))
        self.completion_fp += int(np.sum(bp & ~bt & mask))
        self.completion_fn += int(np.sum(~bp & bt))

        # --- semantics: per-class confusion over known voxels -------------
        yp = y_pred[mask]
        yt = y_true[mask]
        c = self.n_classes
        hist = np.bincount(
            c * yt.astype(np.int64) + yp.astype(np.int64), minlength=c * c
        ).reshape(c, c)
        tp = np.diag(hist)
        self.tps += tp
        self.fps += hist.sum(0) - tp
        self.fns += hist.sum(1) - tp

    def add_batch_ece(
        self,
        ssc_confidence: np.ndarray,
        ssc_pred: np.ndarray,
        sem_prob: np.ndarray,      # [C, ...] per-class probabilities
        target: np.ndarray,
        inference_time: float = 0.0,
    ):
        """Reference ``add_batch_ece`` (``metrics.py:480-523``)."""
        conf = np.asarray(ssc_confidence).reshape(-1)
        pred = np.asarray(ssc_pred).reshape(-1)
        tgt = np.asarray(target).reshape(-1)
        prob = np.asarray(sem_prob).reshape(sem_prob.shape[0], -1).T  # [N, C]
        keep = tgt != 255
        conf, pred, tgt, prob = conf[keep], pred[keep], tgt[keep], prob[keep]
        acc = tgt == pred
        empty = pred == 0

        self.empty_ece += binary_calibration_error(conf[empty], acc[empty])
        self.nonempty_ece += binary_calibration_error(conf[~empty], acc[~empty])
        self.ece_count += 1

        logp = np.log(prob + 1e-12)
        idx = np.clip(tgt, 0, prob.shape[1] - 1).astype(np.int64)
        nll = -logp[np.arange(len(tgt)), idx]
        self.empty_nll += float(np.sum(nll[empty]))
        self.nonempty_nll += float(np.sum(nll[~empty]))
        self.n_empty_voxels += int(np.sum(empty))
        self.n_nonempty_voxels += int(np.sum(~empty))
        self.inference_time += inference_time

    def get_stats(self) -> Dict[str, object]:
        if self.completion_tp != 0:
            precision = self.completion_tp / (self.completion_tp + self.completion_fp)
            recall = self.completion_tp / (self.completion_tp + self.completion_fn)
            iou = self.completion_tp / (
                self.completion_tp + self.completion_fp + self.completion_fn
            )
        else:
            precision = recall = iou = 0.0
        iou_ssc = self.tps / (self.tps + self.fps + self.fns + 1e-5)
        cnt = max(self.ece_count, 1)
        return {
            "precision": precision,
            "recall": recall,
            "iou": iou,
            "iou_ssc": iou_ssc,
            "iou_ssc_mean": float(np.mean(iou_ssc[1:])),
            "empty_ece": self.empty_ece / cnt if self.ece_count else 0.0,
            "nonempty_ece": self.nonempty_ece / cnt if self.ece_count else 0.0,
            "empty_nll": (
                self.empty_nll / self.n_empty_voxels if self.n_empty_voxels else 0.0
            ),
            "nonempty_nll": (
                self.nonempty_nll / self.n_nonempty_voxels
                if self.n_nonempty_voxels
                else 0.0
            ),
            "inference_time": (
                self.inference_time / cnt if self.ece_count else 0.0
            ),
        }
