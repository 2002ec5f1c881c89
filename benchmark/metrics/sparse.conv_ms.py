"""``sparse.conv_ms``: device milliseconds a scan inside the program's
``pasco.sparse.conv`` spans (every gather-GEMM-scatter conv of the sparse
substrate: submanifold, strided and generative), between each span's CUDA
events, over the traced scans."""

from benchmark.spans import device_ms_per_scan


def read(trace):
    return device_ms_per_scan(trace, "pasco.sparse.conv")
