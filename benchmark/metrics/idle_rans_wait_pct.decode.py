"""The share of the profiled call's idle time (inside its ``decode_batch``
span, no kernel running) that fell while the calling thread waited on a
worker's rANS (innermost in ``wait.rans``), in %; the spans are moved onto
the trace's clock by their record's anchor (``harness/program_spans.py``).
A share of the call's own idle, so that the profiler's stretch of the call
cancels. Copies count as idle: the trace keeps kernels alone."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.idle_share(ctx, ("wait.rans",))
