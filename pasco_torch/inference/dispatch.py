"""Scene-adaptive working-box dispatch (counterpart of
``pasco_tpu/inference/dispatch.py``).

The dense-with-masks substrate computes over an axis-aligned box, so its
work scales with the box volume, while a scan's bbox varies with the
augmentation draw (an unaugmented SemanticKITTI scene spans 256x256x32, a
30-degree rotation up to ~350x350x32).  :class:`AdaptiveForward` runs each
scan at the smallest of ``SceneConfig.box_candidates`` that covers its
bbox, through ONE network: the box extent is an argument of
:meth:`DensePaSCoNet.forward`, so there is one parameter set on the card
and nothing is built per box.

The output does not depend on the box that covers the scan: convs and BN
are per channel, the bbox masks read the runtime ``global_min/max``, the
transformer's positional encoding comes from the cell coordinates, and the
extractions keep the flat-index order of ``[X, Z, Y]``, which for a shared
box minimum is the same order in every box that covers the scan.

The sparse substrate (``models/unet.py:PaSCoNet``, one scan per call) takes
the same call: its cell tables and its dense bottleneck span the box.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pasco_torch.core.config import PaSCoConfig
from pasco_torch.utils import timing

Extent = Tuple[int, int, int]


def candidate_boxes(cfg: PaSCoConfig) -> Tuple[Extent, ...]:
    """The candidate boxes, smallest volume first; the configured box
    alone where no candidates are set."""
    cands = cfg.scene.box_candidates
    if not cands:
        return (tuple(cfg.scene.box_extent),)
    return tuple(sorted(set(tuple(c) for c in cands), key=np.prod))


def pick_box(cands: Tuple[Extent, ...], global_min, global_max) -> Extent:
    """Smallest candidate covering ``[global_min, global_max]``; the largest
    where none does (its out-of-box cells are masked off, as with a fixed
    box)."""
    ext = np.asarray(global_max) - np.asarray(global_min) + 1
    for cand in cands:
        if np.all(ext <= np.asarray(cand)):
            return cand
    return cands[-1]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class AdaptiveForward:
    """Callable ``inp -> ModelOutput`` running ``net`` at each scan's box.

    ``box_for`` reads the scan's bbox on the host; a caller that keeps the
    card busy across scans passes the box it took from the host scene
    (``pick_box(fwd.cands, scene.global_min, scene.global_max)``) so that
    no call waits for the card."""

    def __init__(self, net: torch.nn.Module,
                 labelweights: Optional[Dict[int, torch.Tensor]] = None):
        self.net = net
        self.labelweights = labelweights
        self.cands = candidate_boxes(net.cfg)

    def box_for(self, inp) -> Extent:
        return pick_box(self.cands, _host(inp.global_min), _host(inp.global_max))

    def __call__(self, inp, box: Optional[Extent] = None):
        """One scan's forward, the root span ``pasco.dispatch`` of its
        trace (:mod:`pasco_torch.utils.timing`)."""
        with timing.span("dispatch"):
            return self.net(inp, self.labelweights,
                            box_extent=box if box is not None else self.box_for(inp))

    @torch.no_grad()
    def warmup(self, inp) -> None:
        """One forward per candidate, so that the caching allocator and
        cuDNN's per-shape algorithm choice are settled before a box's first
        timed call."""
        for cand in self.cands:
            self(inp, cand)
        if inp.point_feats.is_cuda:
            torch.cuda.synchronize(inp.point_feats.device)
