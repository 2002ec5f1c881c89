"""``dispatch.host_ms``: host milliseconds from the call into the program's
``AdaptiveForward`` to its return (the enqueue; nothing waits for the
card), the mean over the scans of the window after the profiled ones (the
profiler itself slows the host)."""


def read(trace):
    enq = trace.get("enqueue") if trace else None
    return 1e3 * sum(enq) / len(enq) if enq else None
