"""Panoptic Quality (PQ / SQ / RQ / PQ-dagger) accumulators.

NumPy re-implementation of the reference PQ stack
(``pasco/loss/panoptic_quality.py``): :class:`PQStat` accumulators with the
PQ† rule (stuff classes contribute the mean IoU of *all* matches instead of
PQ, reference ``:80-84``), the single-scene update
(``pq_compute_single_core``, ``:175-261``), Hungarian segment matching for
uncertainty evaluation (``find_matched_segment``, ``:96-172``), and the GT
mask-label -> panoptic conversion (``:357-390``).

Everything here runs on host over int label volumes — it is evaluation
bookkeeping, deliberately outside jit.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from pasco_torch import native

OFFSET = 256 * 256 * 256


class PQStatCat:
    __slots__ = ("iou", "tp", "fp", "fn", "all_iou", "all_n")

    def __init__(self):
        self.iou = 0.0
        self.tp = 0
        self.fp = 0
        self.fn = 0
        self.all_iou = 0.0
        self.all_n = 0.0

    def __iadd__(self, o: "PQStatCat") -> "PQStatCat":
        self.iou += o.iou
        self.tp += o.tp
        self.fp += o.fp
        self.fn += o.fn
        self.all_iou += o.all_iou
        self.all_n += o.all_n
        return self


class PQStat:
    def __init__(self):
        self.reset()

    def reset(self):
        self.pq_per_cat: Dict[int, PQStatCat] = defaultdict(PQStatCat)

    def __getitem__(self, i: int) -> PQStatCat:
        return self.pq_per_cat[i]

    def __iadd__(self, o: "PQStat") -> "PQStat":
        for label, cat in o.pq_per_cat.items():
            self.pq_per_cat[label] += cat
        return self

    def pq_average(
        self,
        isthing,
        ignore_cat_id: int,
        thing_ids: Sequence[int],
    ) -> Tuple[Dict[str, float], Dict[int, Dict[str, float]]]:
        """PQ/SQ/RQ averages; PQ† substitutes stuff PQ with mean all-match
        IoU (reference ``pq_average``, ``panoptic_quality.py:49-93``)."""
        pq_dagger = pq = sq = rq = 0.0
        n = 0
        per_class: Dict[int, Dict[str, float]] = {}
        for label, cat in self.pq_per_cat.items():
            if label == ignore_cat_id:
                continue
            if isthing is not None and isthing != (label in thing_ids):
                continue
            if cat.tp + cat.fp + cat.fn == 0:
                per_class[label] = {"pq": 0.0, "sq": 0.0, "rq": 0.0}
                continue
            n += 1
            pq_c = cat.iou / (cat.tp + 0.5 * cat.fp + 0.5 * cat.fn)
            sq_c = cat.iou / cat.tp if cat.tp else 0.0
            rq_c = cat.tp / (cat.tp + 0.5 * cat.fp + 0.5 * cat.fn)
            per_class[label] = {"pq": pq_c, "sq": sq_c, "rq": rq_c}
            pq += pq_c
            sq += sq_c
            rq += rq_c
            if isthing is None:
                if label in thing_ids:
                    pq_dagger += pq_c
                else:
                    pq_dagger += cat.all_iou / max(cat.all_n, 1)
        n = max(n, 1)
        return (
            {
                "pq_dagger": pq_dagger / n,
                "pq": pq / n,
                "sq": sq / n,
                "rq": rq / n,
                "n": n,
            },
            per_class,
        )


def _intersections(
    pan_gt: np.ndarray, pan_pred: np.ndarray, ignore_label: int
) -> Dict[Tuple[int, int], int]:
    combined = pan_gt.astype(np.uint64) * OFFSET + pan_pred.astype(np.uint64)
    labels, counts = np.unique(combined, return_counts=True)
    out = {}
    for label, cnt in zip(labels, counts):
        gt_id = int(label // OFFSET)
        pred_id = int(label % OFFSET)
        if gt_id == ignore_label or pred_id == ignore_label:
            continue
        out[(gt_id, pred_id)] = int(cnt)
    return out


def _areas(pan: np.ndarray) -> Dict[int, int]:
    labels, counts = np.unique(pan, return_counts=True)
    return {int(l): int(c) for l, c in zip(labels, counts)}


def pq_update(
    pq_stat: PQStat,
    gt_segments_info: List[dict],
    pred_segments_info: List[dict],
    pan_gt: np.ndarray,
    pan_pred: np.ndarray,
    thing_ids: Sequence[int],
    ignore_label: int = 0,
) -> set:
    """Accumulate one scene (reference ``pq_compute_single_core``,
    ``panoptic_quality.py:175-261``).  IoU>0.5 TP rule; stuff classes also
    track all matches for PQ†.  Returns the matched (gt, pred) pairs."""
    gt_segms = {el["id"]: dict(el) for el in gt_segments_info}
    pred_segms = {el["id"]: dict(el) for el in pred_segments_info}

    pred_areas = _areas(pan_pred)
    for pid, seg in pred_segms.items():
        seg["area"] = pred_areas.get(pid, 0)
    gt_areas = _areas(pan_gt)
    for gid, seg in gt_segms.items():
        seg["area"] = gt_areas.get(gid, seg.get("area", 0))

    gt_matched, pred_matched, pred_gt_matched = set(), set(), set()
    for (gt_id, pred_id), inter in _intersections(
        pan_gt, pan_pred, ignore_label
    ).items():
        if gt_id not in gt_segms or pred_id not in pred_segms:
            continue
        if gt_segms[gt_id]["category_id"] != pred_segms[pred_id]["category_id"]:
            continue
        union = pred_segms[pred_id]["area"] + gt_segms[gt_id]["area"] - inter
        iou = inter / union if union else 0.0
        cat = gt_segms[gt_id]["category_id"]
        if cat not in thing_ids:
            pq_stat[cat].all_iou += iou
            pq_stat[cat].all_n += 1
            pred_matched.add(pred_id)
            pred_gt_matched.add((gt_id, pred_id))
        if iou > 0.5:
            pq_stat[cat].tp += 1
            pq_stat[cat].iou += iou
            gt_matched.add(gt_id)
            pred_matched.add(pred_id)
            pred_gt_matched.add((gt_id, pred_id))

    for gt_id, seg in gt_segms.items():
        if gt_id not in gt_matched:
            pq_stat[seg["category_id"]].fn += 1
    for pred_id, seg in pred_segms.items():
        if pred_id not in pred_matched:
            pq_stat[seg["category_id"]].fp += 1
    return pred_gt_matched


def find_matched_segments(
    gt_segments_info: List[dict],
    pred_segments_info: List[dict],
    pan_gt: np.ndarray,
    pan_pred: np.ndarray,
    threshold: float = 0.2,
    ignore_label: int = 0,
) -> List[Tuple[int, int]]:
    """IoU-based segment matching for uncertainty eval (reference
    ``find_matched_segment``, ``panoptic_quality.py:96-172``): Hungarian on
    the IoU matrix when threshold < 0.5, greedy IoU>0.5 otherwise."""
    gt_segms = {el["id"]: dict(el) for el in gt_segments_info}
    pred_segms = {el["id"]: dict(el) for el in pred_segments_info}
    pred_areas = _areas(pan_pred)
    gt_areas = _areas(pan_gt)

    inters = _intersections(pan_gt, pan_pred, ignore_label)
    if threshold >= 0.5:
        matched = set()
        for (gt_id, pred_id), inter in inters.items():
            if gt_id not in gt_segms or pred_id not in pred_segms:
                continue
            union = (
                pred_areas.get(pred_id, 0) + gt_areas.get(gt_id, 0) - inter
            )
            if union and inter / union > 0.5:
                matched.add((gt_id, pred_id))
        return sorted(matched)

    max_gt = max(gt_segms.keys(), default=0)
    max_pred = max(pred_segms.keys(), default=0)
    conf = np.zeros((max_gt + 1, max_pred + 1))
    for (gt_id, pred_id), inter in inters.items():
        if gt_id not in gt_segms or pred_id not in pred_segms:
            continue
        union = pred_areas.get(pred_id, 0) + gt_areas.get(gt_id, 0) - inter
        if union:
            conf[gt_id, pred_id] = inter / union
    gt_idx, pred_idx = native.linear_sum_assignment(-conf)
    return [
        (int(g), int(p))
        for g, p in zip(gt_idx, pred_idx)
        if conf[g, p] > threshold
    ]


def mask_labels_to_panoptic(
    labels: np.ndarray,     # [T] class ids
    masks: np.ndarray,      # [T, X, Y, Z] bool
    thing_ids: Sequence[int],
) -> Tuple[np.ndarray, List[dict]]:
    """GT conversion (reference ``convert_mask_label_to_panoptic_output``,
    ``panoptic_quality.py:357-390``): stuff masks of the same class merge
    into one segment."""
    panoptic = np.zeros(masks.shape[1:], dtype=np.int32)
    segments_info: List[dict] = []
    current = 0
    stuff_memory: Dict[int, int] = {}
    for idx, cat in enumerate(labels):
        cat = int(cat)
        if cat == 0:
            continue
        isthing = cat in thing_ids
        mask = masks[idx]
        if not isthing:
            if cat in stuff_memory:
                panoptic[mask] = stuff_memory[cat]
                continue
            stuff_memory[cat] = current + 1
        current += 1
        panoptic[mask] = current
        segments_info.append(
            {
                "id": current,
                "isthing": isthing,
                "category_id": cat,
                "area": int(mask.sum()),
            }
        )
    return panoptic, segments_info
