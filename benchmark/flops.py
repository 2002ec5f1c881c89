"""The work of a forward, counted from the configuration's widths and the
cells each stage keeps (as the reference records them), and the least
time one H100 could take for it.

The counts are what the model needs, whatever implements it: a 3x3x3 conv
over a masked volume does ``Ci * Co`` multiply-adds for every pair of a
valid output cell and a valid neighbour, a product over rows counts only
the rows that hold a cell or a point, attention counts only the valid
keys.  A kernel that also computes zeros, or pads tiles, does more than
this, so a roofline share from these counts is a lower bound.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): 989 TFLOP/s
in bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Iterable

PEAK_BF16 = 989e12
HBM_BYTES_S = 3.35e12
BF16 = 2


def macs(call: dict) -> int:
    """Multiply-adds of one recorded product."""
    k = call["kind"]
    if k == "mm":
        return call["rows"] * call["k"] * call["n"]
    if k == "conv3":
        return call["pairs"] * call["ci"] * call["co"]
    if k == "dense":
        return call["cells"] * call["taps"] * call["ci"] * call["co"]
    if k == "attn":
        return 2 * call["q"] * call["n"] * call["d"]
    raise ValueError(f"unknown product kind {k}")


def model_flops(calls: Iterable[dict]) -> int:
    """FLOPs of a forward: two per multiply-add."""
    return 2 * sum(macs(c) for c in calls)


def conv3_bytes(call: dict) -> int:
    """HBM bytes one masked 3x3x3 conv needs at the least: its bf16 input
    at the valid cells, the skip input there where it has one, its bf16
    output there, the bf16 weights, the f32 bias and BN affine, and the
    one-byte mask over the whole volume."""
    ci, co, n = call["ci"], call["co"], call["cells"]
    return (n * ci * BF16 + n * co * BF16 * (2 if call["skip"] else 1)
            + 27 * ci * co * BF16 + 4 * (co + 2 * ci) + call["mask_cells"])


def conv3_least_s(call: dict) -> float:
    """Least seconds of one masked conv on the card: the larger of its
    operations at the bf16 peak and its bytes at HBM's rate."""
    return max(2 * macs(call) / PEAK_BF16, conv3_bytes(call) / HBM_BYTES_S)
