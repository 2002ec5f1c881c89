"""``device.idle_share.infer``: the share of the traced window in which no
operation ran on the card (one minus the union of the profiler's device
intervals over the window), in percent."""


def read(trace):
    t = trace.get("trace") if trace else None
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
