"""``sparse_conv_roofline``: the least time one H100 needs for the sparse
convs of the traced scans (``benchmark/sparse_flops.py``, from the pairs
and rows the reference records: the operations at the bf16 peak or the
bytes at HBM's rate, whichever is larger, conv by conv) over the device
time of the program's ``pasco.sparse.conv`` spans in those scans, in
percent."""

from benchmark.sparse_flops import least_s
from benchmark.spans import device_ms_per_scan


def read(trace):
    ms = device_ms_per_scan(trace, "pasco.sparse.conv")
    if not ms:
        return None
    scans = trace["scans"]
    least = sum(least_s(trace["pool_calls"][j]) for j in scans) / len(scans)
    return 100.0 * least / (ms / 1e3)
