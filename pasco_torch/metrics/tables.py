"""README-style result table printing (the port's copy of
``pasco_tpu/metrics/tables.py``; NumPy only).

Equivalent of the reference's test-table printers
(``pasco/models/utils.py:22-117``, invoked from ``test_epoch_end``,
``net_panoptic_sparse.py:822-844``): per-method rows of
PQ-dagger / PQ / SQ / RQ (All / Things / Stuff), per-class PQ tables,
SSC mIoU / IoU / P / R, and the uncertainty columns.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def format_panoptic_table(
    summaries: List[Dict], method_names: Sequence[str], class_names: Sequence[str]
) -> str:
    lines = []
    header = (
        f"{'Method':<12}| {'PQ†':>6} | {'PQ':>6} {'SQ':>6} {'RQ':>6} "
        f"| {'PQth':>6} {'SQth':>6} {'RQth':>6} "
        f"| {'PQst':>6} {'SQst':>6} {'RQst':>6}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for name, s in zip(method_names, summaries):
        a, t, st = s["pq_all"], s["pq_things"], s["pq_stuff"]
        lines.append(
            f"{name:<12}| {a['pq_dagger']*100:6.2f} "
            f"| {a['pq']*100:6.2f} {a['sq']*100:6.2f} {a['rq']*100:6.2f} "
            f"| {t['pq']*100:6.2f} {t['sq']*100:6.2f} {t['rq']*100:6.2f} "
            f"| {st['pq']*100:6.2f} {st['sq']*100:6.2f} {st['rq']*100:6.2f}"
        )
    return "\n".join(lines)


def format_per_class_table(
    summaries: List[Dict], method_names: Sequence[str], class_names: Sequence[str]
) -> str:
    lines = []
    for name, s in zip(method_names, summaries):
        lines.append(f"== {name} per-class PQ ==")
        per = s["per_class"]
        for cid in sorted(per):
            cname = (
                class_names[cid] if 0 <= cid < len(class_names) else str(cid)
            )
            r = per[cid]
            lines.append(
                f"  {cname:<16} pq {r['pq']*100:6.2f}  sq {r['sq']*100:6.2f}"
                f"  rq {r['rq']*100:6.2f}"
            )
    return "\n".join(lines)


def format_ssc_table(
    summaries: List[Dict], method_names: Sequence[str], class_names: Sequence[str]
) -> str:
    lines = []
    header = (
        f"{'Method':<12}| {'mIoU':>6} {'IoU':>6} {'Prec':>6} {'Rec':>6}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for name, s in zip(method_names, summaries):
        ssc = s["ssc"]
        lines.append(
            f"{name:<12}| {ssc['iou_ssc_mean']*100:6.2f} {ssc['iou']*100:6.2f} "
            f"{ssc['precision']*100:6.2f} {ssc['recall']*100:6.2f}"
        )
    return "\n".join(lines)


def format_uncertainty_table(
    summaries: List[Dict], method_names: Sequence[str]
) -> str:
    lines = []
    header = (
        f"{'Method':<12}| {'ins ECE':>8} {'ins NLL':>8} "
        f"{'ins Brier':>9} {'ins FPR95':>9} "
        f"| {'ssc ECE ne':>10} {'ssc ECE e':>10} "
        f"| {'ssc NLL ne':>10} {'ssc NLL e':>10}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for name, s in zip(method_names, summaries):
        u, ssc = s["uncertainty"], s["ssc"]
        lines.append(
            f"{name:<12}| {u['ins_ece']:8.4f} {u['ins_nll']:8.4f} "
            f"{u.get('ins_brier', 0.0):9.4f} {u.get('ins_fpr95', 0.0):9.4f} "
            f"| {ssc['nonempty_ece']:10.4f} {ssc['empty_ece']:10.4f} "
            f"| {ssc['nonempty_nll']:10.4f} {ssc['empty_nll']:10.4f}"
        )
    return "\n".join(lines)


def print_all(
    summaries: List[Dict],
    n_infers: int,
    class_names: Sequence[str],
    inference_time: float = 0.0,
    ensemble_time: float = 0.0,
) -> str:
    names = [f"subnet {i}" for i in range(n_infers)] + ["ensemble"]
    names = names[: len(summaries)]
    parts = [
        format_panoptic_table(summaries, names, class_names),
        "",
        format_ssc_table(summaries, names, class_names),
        "",
        format_uncertainty_table(summaries, names),
        "",
        f"inference time: {inference_time:.4f} s/scan   "
        f"ensemble time: {ensemble_time:.5f} s/scan",
        "",
        format_per_class_table(summaries, names, class_names),
    ]
    out = "\n".join(parts)
    print(out)
    return out
