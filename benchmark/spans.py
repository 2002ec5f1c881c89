"""The program's own spans in a traced run (``trace["program"]``: the rows
that ``pasco_torch/utils/timing.py``'s ``drain()`` returns for the traced
passes), as the per-layer readers take them."""

from __future__ import annotations

from typing import Optional


def device_ms_per_scan(trace, name: str) -> Optional[float]:
    """Device milliseconds a scan in the spans ``name`` (each span's CUDA
    events), over the traced scans (one ``pasco.dispatch`` each); None
    where the program recorded no such span."""
    prog = trace.get("program") if trace else None
    if not prog:
        return None
    rows = prog["rows"]
    scans = sum(1 for r in rows if r["name"] == "pasco.dispatch")
    ms = [r["device_ms"] for r in rows if r["name"] == name and r["device_ms"] is not None]
    if not scans or not ms:
        return None
    return sum(ms) / scans
