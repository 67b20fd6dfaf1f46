"""Spans of the decode path: the port's one recorder of where a call's host
time goes.

A span is a named interval of one thread, timed by
``time.perf_counter_ns``, with its own id, the id of the span that caused
it and an optional small dict of counts. The spans of one top-level call
(``decode_batch``, the request) share that call's ``Record``: its spans in
the order they opened, its counters (the root's counts, among them
``images``), whether a ``torch.profiler`` session was active when it
began, and one anchor pair ``(time.time_ns(), time.perf_counter_ns())``
taken at its start. Finished records stay in memory, in a ring of the last
``RING`` calls (``records()``).

A thread's spans nest: ``span`` opens under the innermost span open on the
calling thread. Work handed to another thread names its cause explicitly:
``here()`` on the submitting thread, ``span(name, parent=token)`` on the
worker. A span with no record to join (no call open on the thread) is one
shared no-op context, so code outside a call pays nothing for it.

While a profiler session is active, each span of the call also opens a
``torch.profiler.record_function`` range of its name, so that a trace with
CPU activity shows the spans beside the kernels. The anchor puts every span
on the profiler's clock without the trace's host events: a Chrome trace's
``ts`` (microseconds) plus its ``baseTimeNanoseconds`` is Unix time, and
that base is Unix time floored to ``TRIMONTH_S``-second periods (PyTorch
2.11 and 2.13: ``_trimester_base_ns`` of
``torch/profiler/_chrome_trace_export.py``, libkineto's
``ChromeTraceBaseTime``); ``profiler_us`` does the arithmetic.

The recorder is always on. It adds no device synchronisation and no device
allocation, and changes no order of dispatch. It imports nothing of the
model code, so the model-code-free bundle decoder records through it too.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

RING = 256
TRIMONTH_S = 7889238


class Span:
    """One named interval of one thread (``start`` / ``end`` in
    ``perf_counter_ns``; ``end`` is None while it is open)."""

    __slots__ = ("name", "start", "end", "id", "parent", "thread", "counts")

    def __init__(self, name: str, start: int, end: Optional[int], id: int,
                 parent: Optional[int], thread: int,
                 counts: Optional[Dict[str, int]] = None):
        self.name, self.start, self.end = name, start, end
        self.id, self.parent, self.thread = id, parent, thread
        self.counts = counts or {}

    @property
    def ns(self) -> int:
        return self.end - self.start

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start}, {self.end}, id={self.id}"
                f", parent={self.parent}, counts={self.counts})")


class Record:
    """The spans of one top-level call; ``spans[0]`` is its root."""

    __slots__ = ("spans", "profiled", "anchor")

    def __init__(self, spans: List[Span], profiled: bool,
                 anchor: Tuple[int, int]):
        self.spans, self.profiled, self.anchor = spans, profiled, anchor

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def counters(self) -> Dict[str, int]:
        return self.root.counts

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id]

    def profiler_us(self, ns: int) -> float:
        """A ``perf_counter_ns`` reading of this call on the clock of a
        profiler trace's ``ts``: microseconds after the trace's
        ``baseTimeNanoseconds``."""
        unix, perf = self.anchor
        base = unix // 10 ** 9 // TRIMONTH_S * TRIMONTH_S * 10 ** 9
        return (ns - perf + unix - base) / 1e3


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    """The context of one recorded span: pushes it on its thread's stack
    (and opens its profiler range) on entry, closes both on exit."""

    __slots__ = ("rec", "span", "stack", "range", "ring")

    def __init__(self, rec: Record, span: Span, stack: list,
                 ring: Optional[deque] = None):
        """``ring``: where a root's record goes when it closes (None for
        the spans under the root)."""
        self.rec, self.span, self.stack = rec, span, stack
        self.ring, self.range = ring, None

    def __enter__(self) -> Span:
        self.stack.append((self.rec, self.span))
        if self.span.parent is not None:
            self.rec.spans.append(self.span)
        # the profiler's range opens inside the span, so that its start
        # lies next to the span's
        self.span.start = time.perf_counter_ns()
        if self.rec.profiled:
            self.range = torch.autograd.profiler.record_function(
                self.span.name)
            self.range.__enter__()
        return self.span

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        self.span.end = time.perf_counter_ns()
        self.stack.pop()
        if self.ring is not None:
            self.ring.append(self.rec)
        return False


class Recorder:
    """The process's spans: the ring of the last ``RING`` records."""

    def __init__(self):
        self.ring: deque = deque(maxlen=RING)
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def call(self, name: str, **counts):
        """The span of a top-level call: the root of a new record when no
        call is open on this thread, else a span of the open one."""
        stack = self._stack()
        if stack:
            return self.span(name, **counts)
        span = Span(name, 0, None, next(self._ids), None,
                    threading.get_ident(), counts)
        rec = Record([span], torch._C._autograd._profiler_enabled(),
                     (time.time_ns(), time.perf_counter_ns()))
        return _Open(rec, span, stack, self.ring)

    def span(self, name: str, parent: Optional[Tuple[Record, Span]] = None,
             **counts):
        """A span under the innermost one open on this thread, or under
        ``parent`` (a ``here()`` of another thread)."""
        stack = self._stack()
        top = parent or (stack[-1] if stack else None)
        if top is None:
            return _NOOP
        rec, cause = top
        return _Open(rec, Span(name, 0, None, next(self._ids), cause.id,
                               threading.get_ident(), counts), stack)

    def here(self) -> Optional[Tuple[Record, Span]]:
        """The innermost span open on this thread, with its record, for a
        worker's spans to name as their parent; None outside a call."""
        stack = self._stack()
        return stack[-1] if stack else None

    def open_record(self) -> Optional[Record]:
        """The record of the call open on this thread, or None."""
        stack = self._stack()
        return stack[0][0] if stack else None

    def records(self, n: Optional[int] = None) -> List[Record]:
        """The last ``n`` finished records (all that the ring holds by
        default), oldest first."""
        recs = list(self.ring)
        return recs if n is None else recs[max(0, len(recs) - n):]


RECORDER = Recorder()
call = RECORDER.call
span = RECORDER.span
here = RECORDER.here
open_record = RECORDER.open_record
records = RECORDER.records
