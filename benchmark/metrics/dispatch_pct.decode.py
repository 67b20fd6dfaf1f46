"""The share of the window's ``decode_batch`` time that the calling thread
spent dispatching device work (innermost in a stage's span, an upload or
the start of a fetch: ``program_spans.DISPATCH``), in %
(``harness/program_spans.py``)."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.share(ctx, program_spans.DISPATCH)
