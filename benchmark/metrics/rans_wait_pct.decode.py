"""The share of the window's ``decode_batch`` time that the calling thread
spent blocked on a worker's rANS (innermost in ``wait.rans``), in %
(``harness/program_spans.py``)."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.share(ctx, ("wait.rans",))
