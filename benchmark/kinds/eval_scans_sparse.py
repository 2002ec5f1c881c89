"""Traffic of kind ``eval_scans_sparse``: ``eval_scans``'s loop, pool and
judging over the sparse substrate (``substrate="sparse"``, the published
MinkowskiEngine network, ``models/unet.py:PaSCoNet``).

The loop is :func:`benchmark.kinds.eval_scans.run`, run with three of its
names swapped for the time of the run (:func:`swapped`):

* ``program``: :data:`SPARSE`, the program bridge with ``PaSCoNet``'s
  parameter shapes, and the forward behind :class:`TracedForward`, whose
  ``net`` shows the module timers ``net.transformer`` and, as
  ``bottleneck``, ``net.dense_bottleneck``;
* ``Reference``: :class:`~benchmark.reference.sparse_model.SparseReference`.

The network still runs through the program's ``AdaptiveForward`` at the
box ``pick_box`` gives.  With ``--trace 1`` the program's recorder
(``pasco_torch/utils/timing.py``) is on while the profiler records the
traced passes, and its rows and counters, drained after the window, are
``trace["program"]`` for the readers of ``sparse.conv_ms``,
``sparse.rulebook_ms`` and ``sparse_conv_roofline``; where the program
has no such spans, they read nothing.  The device's shares in the same
traced passes (``device.idle_share.infer``, ``device.mfu.infer``) are
therefore read with the recorder on, where the dense cells read them with
it off.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Dict

import torch

from benchmark import program
from benchmark.kinds import eval_scans
from benchmark.reference.sparse_model import SparseReference


@contextlib.contextmanager
def swapped(module, **names):
    """``module``'s globals ``names`` replaced inside the block."""
    saved = {k: getattr(module, k) for k in names}
    for k, v in names.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def parameter_shapes(cfg: dict) -> Dict[str, tuple]:
    """Name -> shape of every parameter of the sparse network, built on the
    meta device."""
    from pasco_torch.models.unet import PaSCoNet

    with torch.device("meta"):
        net = PaSCoNet(program.program_config(cfg))
    return {n: tuple(p.shape) for n, p in net.named_parameters()}


class TracedForward:
    """The program's ``AdaptiveForward``, with the recorder on for a call
    made while ``torch.profiler`` records, and off for every other."""

    def __init__(self, fwd):
        self.fwd, self.cands = fwd, fwd.cands
        self.net = SimpleNamespace(transformer=fwd.net.transformer,
                                   bottleneck=fwd.net.dense_bottleneck)

    def __call__(self, inp, box=None):
        from pasco_torch.utils import timing

        timing.tracing(torch.autograd._profiler_enabled())
        try:
            return self.fwd(inp, box)
        finally:
            timing.tracing(False)


def build_forward(cfg: dict, weights, device) -> TracedForward:
    return TracedForward(program.build_forward(cfg, weights, device))


SPARSE = SimpleNamespace(**{k: getattr(program, k) for k in (
    "program_config", "model_input", "pick_box", "host_outputs", "attention_masks")},
    parameter_shapes=parameter_shapes, build_forward=build_forward)


def run(ctx: Dict) -> Dict:
    from pasco_torch.utils import timing

    timing.drain()
    with swapped(eval_scans, program=SPARSE, Reference=SparseReference):
        res = eval_scans.run(ctx)
    if ctx["trace"]:
        res["trace"]["program"] = timing.drain()
    return res


trace_fields = eval_scans.trace_fields
