"""The least time one H100 needs for a sparse conv, counted from what the
reference records (``benchmark/reference/sparse_model.py``: a ``conv3``
record with ``taps`` and ``rows_in``), whatever implements the conv.

Operations: two per multiply-add of a (output cell, input neighbour) pair
that exists, ``2 * pairs * ci * co``, at the bf16 peak.  Bytes: each input
row the conv reads once (``rows_in * ci``), the weights (``taps * ci *
co``) and each output row once (``cells * co``), all bf16, at HBM's rate.
A kernel that also computes padded rows or absent neighbours does more
than this, so a share of this least time is a lower bound, and one that
reads a gathered row more than once from HBM reads more than this.
"""

from __future__ import annotations

from typing import Iterable

from benchmark.flops import BF16, HBM_BYTES_S, PEAK_BF16, macs


def is_sparse_conv(call: dict) -> bool:
    return call["kind"] == "conv3" and "rows_in" in call


def sconv_bytes(call: dict) -> int:
    """HBM bytes one sparse conv needs at the least."""
    return BF16 * (call["rows_in"] * call["ci"] + call["taps"] * call["ci"] * call["co"]
                   + call["cells"] * call["co"])


def sconv_least_s(call: dict) -> float:
    """Least seconds of one sparse conv: the larger of its operations at
    the bf16 peak and its bytes at HBM's rate."""
    return max(2 * macs(call) / PEAK_BF16, sconv_bytes(call) / HBM_BYTES_S)


def least_s(calls: Iterable[dict]) -> float:
    """Least seconds of the sparse convs among ``calls``."""
    return sum(sconv_least_s(c) for c in calls if is_sparse_conv(c))
