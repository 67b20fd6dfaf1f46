"""The card's idle share in a decode call: one less the busy time of the
call profiled with CUDA activity alone (the union of its kernel, copy and
fill intervals) over the median seconds of the window's unprofiled calls
on the host's clock. The profiled call's own window is not used: the
profiler slows every launch on the host, and these calls are paced by
the host."""

import statistics


def read(ctx):
    t = ctx["trace"]
    if t is None or t.busy_s <= 0 or not ctx["call_s"]:
        return None
    return 100.0 * (1.0 - t.busy_s / statistics.median(ctx["call_s"]))
