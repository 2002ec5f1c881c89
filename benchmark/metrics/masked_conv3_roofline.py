"""``masked_conv3_roofline``: the least time one H100 needs for the masked
3x3x3 convs of the traced scans (``benchmark/flops.py``, from the cells
each conv's mask keeps: the operations at the bf16 peak or the bytes at
HBM's rate, whichever is larger, conv by conv) over the device time of the
kernel ``masked_conv3`` in the trace, in percent."""

from benchmark.flops import conv3_least_s


def read(trace):
    t = trace.get("trace") if trace else None
    if not t:
        return None
    spent = sum(s for name, s in t["kernel_s"].items() if "masked_conv3" in name)
    if spent <= 0:
        return None
    least = sum(conv3_least_s(c) for j in trace["scans"]
                for c in trace["pool_calls"][j] if c["kind"] == "conv3")
    return 100.0 * least / spent
