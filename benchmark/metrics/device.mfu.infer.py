"""``device.mfu.infer``: the model FLOPs of the scans the traced window
completed (``benchmark/flops.py``: the products each scan needs, from
the configuration's widths and the cells each stage keeps) over the
window's seconds times one H100's bf16 peak (989 TFLOP/s), in percent."""

from benchmark.flops import PEAK_BF16, model_flops


def read(trace):
    t = trace.get("trace") if trace else None
    if not t or t["window_s"] <= 0:
        return None
    total = sum(model_flops(trace["pool_calls"][j]) for j in trace["scans"])
    return 100.0 * total / (t["window_s"] * PEAK_BF16)
