"""``model.transformer_ms``: device milliseconds of the mask transformer
(``DensePaSCoNet.transformer``) per scan, between CUDA events recorded in
its forward pre- and post-hooks, the mean over the traced scans."""


def read(trace):
    ms = trace.get("transformer") if trace else None
    return sum(ms) / len(ms) if ms else None
