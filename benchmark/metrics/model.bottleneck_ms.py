"""``model.bottleneck_ms``: device milliseconds of the dense bottleneck
(``DensePaSCoNet.bottleneck``) per scan, between CUDA events recorded in
its forward pre- and post-hooks, the mean over the traced scans."""


def read(trace):
    ms = trace.get("bottleneck") if trace else None
    return sum(ms) / len(ms) if ms else None
