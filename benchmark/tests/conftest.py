"""Shared pieces of the benchmark's CPU tests: the repository root on the
import path, and a cell at ``tiny_config`` size."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# At tiny_config size the port runs in float32 on the CPU (``compute_dtype``
# float32; its semantic logits and attention operands still round to
# bfloat16), against the float32 reference that follows its keep decisions
# and attention masks.  Over 7 seeds of 2 scans each, at n_infers 1 and 3:
# logit_gap <= 0.0035 (the bfloat16 rounding of the logits, 2^-8),
# sem_rel <= 0.0017, mask_rel <= 0.0019, query_rel <= 0.00084; the float8
# control reads at least 0.103, 0.060, 0.0123 and 0.0076 on the same scans.
# Each limit lies between the two, with about as much room on either side.
TINY_LIMITS = {"logit_gap": 0.02, "sem_rel": 0.01, "mask_rel": 0.005, "query_rel": 0.0025}


def tiny_cell(n_infers: int):
    """(configuration dict, traffic dict) of a tiny eval cell."""
    from pasco_torch.core.config import tiny_config

    cfg = tiny_config(n_infers).to_dict()
    cfg["model"]["compute_dtype"] = "float32"
    cfg["limits"] = dict(TINY_LIMITS)
    traffic = dict(kind="eval_scans", pool=2, points=2000, angles_deg=[3, 12, 20, 30],
                   max_translation=[0.2, 0.2, 0.1], workers=1)
    return cfg, traffic


@pytest.fixture(params=[1, 3], ids=["single", "mimo3"])
def cell(request):
    return tiny_cell(request.param)
