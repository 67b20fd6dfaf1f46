"""The readers of the program's spans (``harness/program_spans.py`` and the
five metrics on it), on records and a trace made by hand."""

from __future__ import annotations

import sys

import pytest

from benchmark.harness import cell as cells
from benchmark.harness import trace
from onedc_tpu_torch.utils import spans

MS = 1_000_000
# a Unix time 5 s after the start of a profiler base period, read at
# perf_counter_ns 0: a span at t ns lies at 5 + t / 1e9 s on the trace's
# clock
ANCHOR = (spans.TRIMONTH_S * 10 ** 9 * 230 + 5 * 10 ** 9, 0)

# (name, start ms, end ms, parent's index, thread, counts): one call of
# 100 ms. The calling thread's innermost time: decode_batch 2, parse 2,
# bucket 50, chunk.begin 7, upload 1, wait.rans 20, chunk.update 9, fetch
# 1, stitch 8
CALL = [("decode_batch", 0, 100, None, 1, {"images": 4}),
        ("parse", 0, 2, 0, 1, {}),
        ("bucket", 2, 98, 0, 1, {}),
        ("chunk.begin", 2, 10, 2, 1, {}),
        ("upload", 3, 4, 3, 1, {}),
        ("rans.decode", 12, 28, 3, 2, {}),
        ("wait.rans", 10, 30, 2, 1, {}),
        ("chunk.update", 30, 40, 2, 1, {}),
        ("fetch", 35, 36, 7, 1, {}),
        ("rans.decode", 41, 45, 7, 2, {}),
        ("stitch", 90, 98, 2, 1, {})]
# kernels on the trace's clock: 4.5-5 ms (launched after the upload of
# 3-4 ms), 12-20 ms and 31-60 ms of the call, so 62.5 ms of its 100 are
# idle
KERNELS = [("k", 5.0045, 0.0005), ("k", 5.012, 0.008), ("k", 5.031, 0.029)]


def record(profiled=False, shift_ms=0):
    out = []
    for i, (name, a, b, parent, thread, counts) in enumerate(CALL):
        out.append(spans.Span(name, (a + shift_ms) * MS, (b + shift_ms) * MS,
                              i + 1, None if parent is None else parent + 1,
                              thread, dict(counts)))
    return spans.Record(out, profiled, ANCHOR)


@pytest.fixture
def read(monkeypatch):
    """The metric ``name`` read from ``ctx`` with ``recs`` as the
    recorder's records."""
    def read(name, recs, **ctx):
        ctx.setdefault("call_s", [0.1])
        ctx.setdefault("trace", None)
        monkeypatch.setattr(spans, "records", lambda n=None: list(recs))
        return cells.reader(name)(ctx)
    return read


def kernels(ks):
    return trace.Trace(window_s=0.2, busy_s=0.05, kernels=ks, device_ops=[])


def test_the_calling_threads_time_sums_to_the_call():
    from benchmark.harness import program_spans

    by = program_spans.self_ns([record()])
    assert by == {"decode_batch": 2 * MS, "parse": 2 * MS, "bucket": 50 * MS,
                  "chunk.begin": 7 * MS, "upload": MS, "wait.rans": 20 * MS,
                  "chunk.update": 9 * MS, "fetch": MS, "stitch": 8 * MS}


@pytest.mark.parametrize("name,value", [
    ("rans_ms_per_img.decode", 5.0),      # (16 + 4) ms over 4 images
    ("rans_wait_pct.decode", 20.0),
    ("dispatch_pct.decode", 18.0)])       # 7 + 1 + 9 + 1 of 100 ms
def test_window_readers(read, name, value):
    # the profiled call after the window is left out of it
    recs = [record(), record(profiled=True, shift_ms=200)]
    assert read(name, recs) == pytest.approx(value)


@pytest.mark.parametrize("call_s", [[0.25], [0.09], [0.1, 0.1], []])
def test_window_readers_hold_the_records_against_the_calls(read, call_s):
    # a record under half its call, longer than it, or a call without one
    for name in ("rans_ms_per_img.decode", "rans_wait_pct.decode",
                 "dispatch_pct.decode"):
        assert read(name, [record()], call_s=call_s) is None


@pytest.mark.parametrize("ring,call_s,value", [
    # the ring kept the window's last two calls of three
    (3, [0.3, 0.1, 0.1], 20.0),
    # a window as long as the ring: a record for each call
    (3, [0.1, 0.1], 20.0),
    # a ring with room left has dropped nothing: a call lacks its record
    (4, [0.3, 0.1, 0.1], None),
    # the last calls are still held against their records
    (3, [0.1, 0.1, 0.3], None)])
def test_a_window_longer_than_the_ring(read, monkeypatch, ring, call_s,
                                       value):
    monkeypatch.setattr(spans, "RING", ring)
    recs = [record(), record(shift_ms=100),
            record(profiled=True, shift_ms=200)]
    got = read("rans_wait_pct.decode", recs, call_s=call_s)
    assert got == (None if value is None else pytest.approx(value))


@pytest.mark.parametrize("name,value", [
    # idle 12-30 ms of the 10-30 ms wait, of 62.5 idle ms
    ("idle_rans_wait_pct.decode", 19.2),
    # idle 2-4.5 and 5-10 ms in chunk.begin and its upload, 30-31 ms in
    # chunk.update
    ("idle_dispatch_pct.decode", 13.6)])
def test_idle_readers(read, name, value):
    recs = [record(), record(profiled=True)]
    assert read(name, recs, trace=kernels(KERNELS)) == pytest.approx(value)


def test_the_idle_shares_sum_to_the_calls_idle(monkeypatch):
    from benchmark.harness import program_spans

    monkeypatch.setattr(spans, "records",
                        lambda n=None: [record(profiled=True)])
    ctx = {"call_s": [0.1], "trace": kernels(KERNELS)}
    every = {name for name, *_ in CALL}
    assert program_spans.idle_share(ctx, every) == pytest.approx(100.0)


@pytest.mark.parametrize("ks", [
    # the first kernel 2.5 ms after the first upload ends (4 ms): the
    # clocks disagree
    [("k", 5.0065, 0.001)] + KERNELS[1:],
    # a kernel before the root begins
    [("k", 4.999, 0.001)] + KERNELS,
    # no kernel
    []])
def test_idle_readers_check_the_alignment(read, ks):
    recs = [record(profiled=True)]
    for name in ("idle_rans_wait_pct.decode", "idle_dispatch_pct.decode"):
        assert read(name, recs, trace=kernels(ks)) is None


def test_idle_readers_need_a_profiled_call_with_a_copy(read):
    no_copy = record(profiled=True)
    no_copy.spans[4].name = "chunk.begin"
    assert read("idle_dispatch_pct.decode", [no_copy],
                trace=kernels(KERNELS)) is None


def test_idle_readers_need_a_profiled_call(read):
    assert read("idle_dispatch_pct.decode", [record()],
                trace=kernels(KERNELS)) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import onedc_tpu_torch.utils

    # as at a commit before the recorder: the module cannot be imported
    monkeypatch.delattr(onedc_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "onedc_tpu_torch.utils.spans", None)
    ctx = {"call_s": [0.1], "trace": kernels(KERNELS)}
    for name in ("rans_ms_per_img.decode", "rans_wait_pct.decode",
                 "dispatch_pct.decode", "idle_rans_wait_pct.decode",
                 "idle_dispatch_pct.decode"):
        assert cells.reader(name)(ctx) is None
