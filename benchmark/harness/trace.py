"""The device trace of whole calls: ``torch.profiler``, exported as a Chrome
trace into a temporary directory under ``TMPDIR``, read back and deleted.

``profile`` records CUDA activity alone, which slows each launch on the
host less than CPU activity does (a host-paced call still takes 15-40 %
longer): from it the kernels (name, start, duration), the time the
device was busy (the union of kernel, copy and fill intervals), the device
operations that took the most time, and the call's window on the host's
clock. ``idle_gaps`` records the host's operations as well, which slows
each launch on the host and so stretches the window: it serves only to
name the longest idle gaps by the host operation running in each.
"""

from __future__ import annotations

import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, List, NamedTuple, Tuple

import torch

MARK = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ACT = torch.profiler.ProfilerActivity


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]   # (name, start s, dur s)
    device_ops: List[Tuple[str, float]]       # by name, summed, longest first


def union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _events(fn: Callable[[], None], device, acts) -> Tuple[list, float]:
    """Run ``fn()`` under the profiler, the device synchronised at its end:
    (the trace's events, the seconds ``fn`` took on the host's clock)."""
    tmp = Path(tempfile.mkdtemp(prefix="benchmark_trace_"))
    cuda = torch.device(device).type == "cuda"
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(MARK):
                t0 = time.perf_counter()
                fn()
                if cuda:
                    torch.cuda.synchronize(device)
                seconds = time.perf_counter() - t0
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        with path.open() as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return events, seconds


def _device_ops(events: list):
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("cat")) for e in events
            if e.get("cat") in DEVICE_CATS and "dur" in e]


def profile(fn: Callable[[], None], device) -> Trace:
    """The ``Trace`` of ``fn()`` (which starts with the device idle) under
    the profiler's CUDA activity alone (on a CPU, which has no device
    events, its CPU activity)."""
    cuda = torch.device(device).type == "cuda"
    events, seconds = _events(fn, device, [ACT.CUDA if cuda else ACT.CPU])
    return read(events, seconds)


def read(events: list, window_s: float) -> Trace:
    """A Chrome trace's device events and the window's seconds ->
    ``Trace``."""
    dev = _device_ops(events)
    by_name: dict = {}
    for n, s, e, _ in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    kernels = [(n, s * 1e-6, (e - s) * 1e-6) for n, s, e, c in dev
               if c == "kernel"]
    return Trace(window_s, union([(s, e) for _, s, e, _ in dev]) * 1e-6,
                 kernels, [(short(n), v) for n, v in device_ops[:10]])


def idle_gaps(fn: Callable[[], None], device, top: int = 10):
    """Run ``fn()`` under the profiler's CPU and CUDA activity: the
    ``top`` longest spans of its window with no device operation running,
    each (the innermost host operation running at its middle, seconds)."""
    events, _ = _events(fn, device, [ACT.CPU, ACT.CUDA])
    return gaps_of(events, top)


def gaps_of(events: list, top: int = 10):
    mark = [e for e in events if e.get("name") == MARK and "dur" in e
            and e.get("cat") == "user_annotation"]
    if not mark:
        mark = [e for e in events if e.get("name") == MARK and "dur" in e]
    t0 = float(mark[0]["ts"])
    t1 = t0 + float(mark[0]["dur"])
    dev = [(max(s, t0), min(e, t1)) for _, s, e, _ in _device_ops(events)
           if s < t1 and e > t0]
    cpu = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in events if e.get("cat") == "cpu_op" and "dur" in e]
    gaps, end = [], t0
    for s, e in sorted(dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        ops = [c for c in cpu if c[0] <= mid <= c[1]]
        name = min(ops, key=lambda c: c[1] - c[0])[2] if ops else "no host op"
        out.append((short(name), (e - s) * 1e-6))
    return out


def short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit]
