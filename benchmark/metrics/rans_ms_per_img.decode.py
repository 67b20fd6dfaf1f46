"""Host rANS per decoded image: the summed ``rans.decode`` spans of the
window's unprofiled calls (the native decode of each chunk step, on the
pipeline's worker threads or the calling thread) over the images those
calls decoded, in ms (``harness/program_spans.py``)."""

from benchmark.harness import program_spans


def read(ctx):
    recs = program_spans.window(ctx)
    if not recs:
        return None
    ns = [s.ns for r in recs for s in r.spans if s.name == "rans.decode"]
    images = sum(r.counters.get("images", 0) for r in recs)
    if not ns or not images:
        return None
    return sum(ns) * 1e-6 / images
