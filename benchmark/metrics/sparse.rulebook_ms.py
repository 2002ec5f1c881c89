"""``sparse.rulebook_ms``: device milliseconds a scan inside the program's
``pasco.sparse.rulebook`` spans (the kernel map of each submanifold conv's
coordinate set, and each down conv's unique and map), between each span's
CUDA events, over the traced scans."""

from benchmark.spans import device_ms_per_scan


def read(trace):
    return device_ms_per_scan(trace, "pasco.sparse.rulebook")
