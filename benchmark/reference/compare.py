"""The numbers that decide ``correct`` for a scan: the program's outputs, as
copied to the host, against the reference's, cell by cell.

The reference follows the judged side's keep decisions where that side's
extractions show them (:meth:`Reference.force`), and its attention masks
in every round of the transformer: a near tie that rounding decides the
other way would otherwise change all that follows it.  Cells are matched
by their coordinates.

* ``logit_gap``: the widest gap, as a share of the reference's largest
  logit, between the two sides' semantic output: a scale-1 logit's value
  where both kept a cell, or the reference's margin (the best non-empty
  class against "empty") where they decided a keep apart, over the
  semantic grids of scales 4, 2 and 1 and the panoptic grids of every
  scale and subnet.  A cell on a tie (all logits near 0) is decided by
  rounding; one far from it is a fault.
* ``sem_rel``: the L2 norm of the scale-1 semantic logits' difference
  over that of the reference's, on the cells both kept.
* ``mask_rel``: the same for the transformer's voxel mask logits on the
  matched scale-1 panoptic cells, for the worst subnet.
* ``query_rel``: the same for the query class logits, for the worst
  subnet.
"""

from __future__ import annotations

from typing import Dict

import torch

NUMBERS = ("logit_gap", "sem_rel", "mask_rel", "query_rel")


def _keys(c: torch.Tensor) -> torch.Tensor:
    c = c.long() + 4096
    return (c[:, 0] * 16384 + c[:, 1]) * 16384 + c[:, 2]


def match(prog_coords: torch.Tensor, ref_coords: torch.Tensor):
    """(rows of the program, rows of the reference) of the cells both
    hold, and the number of cells that only one side holds."""
    kp, kr = _keys(prog_coords), _keys(ref_coords)
    order = torch.argsort(kr)
    sr = kr[order]
    pos = torch.searchsorted(sr, kp).clamp(max=max(sr.numel() - 1, 0))
    found = sr.numel() > 0
    hit = (sr[pos] == kp) if found else torch.zeros_like(kp, dtype=torch.bool)
    rows_p = hit.nonzero()[:, 0]
    rows_r = order[pos[rows_p]]
    only = (kp.numel() - rows_p.numel()) + (kr.numel() - rows_r.numel())
    return rows_p, rows_r, only


def _gap(p: torch.Tensor, r: torch.Tensor):
    """(widest gap over the reference's largest magnitude, L2 of the
    difference over the reference's)."""
    p, r = p.double(), r.double()
    if r.numel() == 0:
        return 0.0, 0.0
    scale = max(r.abs().max().item(), 1e-30)
    gap = (p - r).abs().max().item() / scale
    rel = (p - r).norm().item() / max(r.norm().item(), 1e-30)
    return gap, rel


def from_host(host: Dict[str, torch.Tensor], n_infers: int, device) -> dict:
    """The program's host copy (:func:`benchmark.program.host_outputs`) in
    the reference's form (:meth:`Reference.forward`): valid rows only."""
    h = {k: v.to(device) for k, v in host.items()}
    m1 = h["sem1.mask"]
    out = {"caps": {**{("sem", s): h[f"sem{s}.mask"].shape[-1] for s in (4, 2, 1)},
                    **{("panop", s): h[f"panop{s}.mask"].shape[-1] for s in (4, 2, 1)}},
           "sem": {s: h[f"sem{s}.coords"][h[f"sem{s}.mask"]][:, 1:] for s in (4, 2, 1)},
           "sem_logits": h["sem1.logits"][m1].float(),
           "panop": {s: [h[f"panop{s}.coords"][i][h[f"panop{s}.mask"][i]][:, 1:]
                         for i in range(n_infers)] for s in (4, 2, 1)},
           "mask_logits": [h["mask_logits"][i][h["panop1.mask"][i]].float()
                           for i in range(n_infers)],
           "query_logits": h["query_logits"].float()}
    if "attn" in h:
        out["attn"] = [[r[i][h["panop1.mask"][i]] for i in range(n_infers)] for r in h["attn"]]
    return out


def compare(got: dict, ref: dict) -> Dict[str, float]:
    """The numbers of one scan, for two outputs in the reference's form;
    ``ref`` followed ``got``'s decisions (:func:`follow`)."""
    rp, rr, _ = match(got["sem"][1], ref["sem"][1])
    sem_gap, sem_rel = _gap(got["sem_logits"][rp], ref["sem_logits"][rr])
    mask_rel = query_rel = 0.0
    for i, (gc, rc) in enumerate(zip(got["panop"][1], ref["panop"][1])):
        rp, rr, _ = match(gc, rc)
        mask_rel = max(mask_rel, _gap(got["mask_logits"][i][rp], ref["mask_logits"][i][rr])[1])
        query_rel = max(query_rel, _gap(got["query_logits"][i], ref["query_logits"][i])[1])
    return dict(logit_gap=max(sem_gap, ref["keep_gap"]), sem_rel=sem_rel,
                mask_rel=mask_rel, query_rel=query_rel)


def compare_scan(host: Dict[str, torch.Tensor], reference, scan, n_infers: int,
                 device) -> Dict[str, float]:
    """The numbers of one scan: the program's host copy against the
    reference's forward of the same scan, which follows the program's keep
    decisions where they are known (:meth:`Reference.force`) and its
    attention masks where the host copy has them."""
    got = from_host(host, n_infers, device)
    return compare(got, follow(reference, scan, got, device))


def follow(reference, scan, got: dict, device) -> dict:
    """The reference's forward of ``scan`` following ``got``'s keep
    decisions and, where ``got`` has them, its attention masks."""
    return reference.forward(scan, device, follow=got)


def over_scans(readings) -> Dict[str, float]:
    """A run's reading of every number: the worst of its checked scans."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}
