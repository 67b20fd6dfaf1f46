"""The program's own spans (``onedc_tpu_torch/utils/spans.py``) of the
calls a traced run made, as the per-layer metrics of the decode read them.

The window's calls are the last ``len(ctx["call_s"])`` records of
``decode_batch`` that ran without the profiler, each held against its
call's seconds on the host's clock: its root span no longer than the call
and at least half of it. A window of more calls than the recorder's ring
holds is read over its last calls, as many as the ring kept. The calling
thread's time goes to the innermost span open on it, so its categories
sum to the root's time. The profiled call is the profiled record whose
root, moved onto the trace's clock by the record's anchor, holds the first
kernel of ``ctx["trace"]``, so that every kernel starts after the root
begins. Its idle time is read as shares of itself: the profiler stretches
the profiled call, and the idle in it, so only the split of that idle is
read there (``idle_pct.decode`` gives its size from the host's clock). The clocks are held to each
other where a launch follows a known host event: a call's first device
work is the copy of its z indices (its first ``upload`` or
``wait.device`` span), and its first kernel is launched right after that
copy is issued, so the first kernel must start within ``ALIGN_S`` of that
span's end, or nothing is read. A program without the recorder, or a run
whose records fail a check, gives None.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

ROOT = "decode_batch"
# the calling thread's spans that dispatch device work: the stages, the
# uploads and the starts of index fetches
DISPATCH = ("chunk.begin", "chunk.update", "chunk.x0", "chunk.vae", "z_only",
            "upload", "fetch")
ALIGN_S = 2e-3
# the spans of a host-to-device copy, after the first of which a call
# launches its first kernel
COPY_IN = ("upload", "wait.device")


def _recorder():
    try:
        from onedc_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def window(ctx) -> Optional[list]:
    """The records of the window's calls, oldest first, or None."""
    spans = _recorder()
    call_s = ctx.get("call_s") or []
    if spans is None or not call_s:
        return None
    ring = spans.records()
    recs = [r for r in ring if not r.profiled and r.root.name == ROOT]
    # a full ring has dropped the window's first calls
    n = len(call_s) if len(ring) < spans.RING else min(len(call_s),
                                                         len(recs))
    if not n or len(recs) < n:
        return None
    recs, call_s = recs[len(recs) - n:], call_s[len(call_s) - n:]
    for r, s in zip(recs, call_s):
        if not 0.5 * s <= r.root.ns * 1e-9 <= s:
            return None
    return recs


def pieces(rec) -> List[Tuple[str, int, int]]:
    """The calling thread's time in ``rec`` as (name of the innermost open
    span, start ns, end ns), in order."""
    root = rec.root
    kids: Dict[int, list] = {}
    for s in rec.spans[1:]:
        if s.thread == root.thread:
            kids.setdefault(s.parent, []).append(s)
    out: List[Tuple[str, int, int]] = []

    def walk(span):
        t = span.start
        for c in sorted(kids.get(span.id, ()), key=lambda c: c.start):
            if c.start > t:
                out.append((span.name, t, c.start))
            walk(c)
            t = max(t, c.end)
        if span.end > t:
            out.append((span.name, t, span.end))
    walk(root)
    return out


def self_ns(recs) -> Dict[str, int]:
    """Calling-thread ns by innermost span name, summed over ``recs``."""
    out: Dict[str, int] = {}
    for r in recs:
        for name, a, b in pieces(r):
            out[name] = out.get(name, 0) + b - a
    return out


def share(ctx, names) -> Optional[float]:
    """% of the window's ``decode_batch`` time that the calling thread
    spent innermost in a span named in ``names``."""
    recs = window(ctx)
    if not recs:
        return None
    by = self_ns(recs)
    return 100.0 * sum(by.get(n, 0) for n in names) / sum(
        r.root.ns for r in recs)


def profiled(ctx):
    """(record, root start s, root end s, merged kernel intervals in s on
    the trace's clock) of the profiled call that ``ctx["trace"]`` read, or
    None."""
    spans, t = _recorder(), ctx.get("trace")
    if spans is None or t is None or not t.kernels:
        return None
    first = min(s for _, s, _ in t.kernels)
    for rec in reversed(spans.records()):
        if not rec.profiled or rec.root.name != ROOT:
            continue
        r0 = rec.profiler_us(rec.root.start) * 1e-6
        r1 = rec.profiler_us(rec.root.end) * 1e-6
        if r0 <= first <= r1:
            copy = next((s for s in rec.spans if s.name in COPY_IN
                         and s.thread == rec.root.thread), None)
            if copy is None or abs(
                    first - rec.profiler_us(copy.end) * 1e-6) > ALIGN_S:
                return None
            return rec, r0, r1, merged([(s, s + d) for _, s, d in t.kernels])
    return None


def merged(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_in(busy, a: float, b: float) -> float:
    """Seconds of [a, b] that the merged intervals ``busy`` cover."""
    total = 0.0
    i = max(0, bisect.bisect_right(busy, (a, float("inf"))) - 1)
    while i < len(busy) and busy[i][0] < b:
        total += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return total


def idle_share(ctx, names) -> Optional[float]:
    """% of the profiled call's idle time (inside its ``decode_batch``
    span, no kernel running) that fell while the calling thread was
    innermost in a span named in ``names``."""
    found = profiled(ctx)
    if found is None:
        return None
    rec, r0, r1, busy = found
    idle_all = (r1 - r0) - busy_in(busy, r0, r1)
    if idle_all <= 0:
        return None
    idle = 0.0
    for name, a, b in pieces(rec):
        if name in names:
            a = rec.profiler_us(a) * 1e-6
            b = rec.profiler_us(b) * 1e-6
            idle += (b - a) - busy_in(busy, a, b)
    return 100.0 * idle / idle_all
