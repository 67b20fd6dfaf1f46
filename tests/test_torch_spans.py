"""The span recorder (``onedc_tpu_torch/utils/spans.py``) on the decode path
(tiny geometry, f32, CPU): one tree per ``decode_batch`` call, the same
images with the recorder on and off, and the spans on the profiler's
clock."""

import contextlib
import json

import pytest
import torch

from chip_smoke import write_synthetic_stream
from onedc_tpu_torch.models.onedc import OneDCRuntime
from onedc_tpu_torch.utils import spans
from onedc_tpu_torch.utils.logging import profile_trace
from torch_port_common import one_torch_thread, port_model  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")



@pytest.fixture(scope="module")
def rt_streams():
    """The tiny runtime and three streams: two of one padded size (the
    pipelined schedule) and one of another (``decode_padded``)."""
    rt = OneDCRuntime(port_model(), device="cpu")
    return rt, [write_synthetic_stream(rt, h, w, seed)[0]
                for h, w, seed in ((64, 64, 1), (50, 39, 2), (64, 128, 3))]


@pytest.fixture
def fresh_ring():
    spans.RECORDER.ring.clear()


@pytest.mark.usefixtures("fresh_ring")
def test_a_decode_batch_records_one_tree(rt_streams):
    rt, streams = rt_streams
    rt.decode_batch(streams)
    [rec] = spans.records()
    root = rec.root
    assert root.name == "decode_batch" and rec.counters == {"images": 3}
    assert not rec.profiled
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans) and root.parent is None
    mine = [s for s in rec.spans[1:] if s.thread == root.thread]
    workers = [s for s in rec.spans if s.thread != root.thread]
    # the calling thread's spans nest inside their parents, down from the
    # root
    for s in mine:
        parent = by_id[s.parent]
        assert parent.thread == root.thread
        assert parent.start <= s.start <= s.end <= parent.end
    # a worker's spans name the chunk span that submitted them: the
    # pipelined bucket's four steps; the single stream's four run on the
    # calling thread, in decode_padded
    assert [s.name for s in workers] == ["rans.decode"] * 4
    for s in workers:
        cause = by_id[s.parent]
        assert cause.thread == root.thread
        assert cause.name in ("chunk.begin", "chunk.update")
        assert cause.start <= s.start and s.end <= root.end
    assert [by_id[s.parent].name for s in mine
            if s.name == "rans.decode"] == ["decode_padded"] * 4
    # only the root counts
    assert all(not s.counts for s in rec.spans[1:])
    names = [s.name for s in mine]
    for name, n in (("parse", 1), ("bucket", 2), ("chunk.begin", 2),
                    ("chunk.update", 8),
                    ("chunk.x0", 2), ("wait.rans", 4), ("wait.device", 4),
                    ("stitch", 3), ("decode_padded", 1)):
        assert names.count(name) == n, name


@pytest.mark.usefixtures("fresh_ring")
def test_images_are_the_same_with_the_recorder_off(rt_streams, monkeypatch):
    rt, streams = rt_streams
    on = rt.decode_batch(streams)
    # a traced decode times its stages from its own spans, a record of
    # its own
    trace = {}
    rt.decode(streams[2], trace)
    assert [r.root.name for r in spans.records()] == ["decode_batch",
                                                      "decode_padded"]
    assert list(trace["stage_ms"]) == ["begin", "updates_with_rans",
                                       "finish_unet_x0", "vae"]
    assert all(ms > 0 for ms in trace["stage_ms"].values())
    # every span a no-op, as in a program without the recorder
    for name in ("call", "span"):
        monkeypatch.setattr(spans, name,
                            lambda *a, **k: contextlib.nullcontext())
    spans.RECORDER.ring.clear()
    off = rt.decode_batch(streams)
    assert spans.records() == []
    for a, b in zip(on, off):
        assert torch.equal(a, b)


@pytest.mark.usefixtures("fresh_ring")
def test_spans_sit_on_the_profilers_clock(rt_streams, tmp_path):
    rt, streams = rt_streams
    with profile_trace(tmp_path):
        rt.decode_batch(streams[:2])
    [rec] = spans.records()
    assert rec.profiled
    [path] = tmp_path.glob("trace_*.json")
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    marks = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            marks.setdefault(e["name"], []).append(float(e["ts"]))
    unix, perf = rec.anchor
    mine = [s for s in rec.spans if s.thread == rec.root.thread]
    assert len(mine) > 10
    for s in mine:
        # the anchored start in Unix ns, and on the trace's own clock
        got = min(marks[s.name], key=lambda ts: abs(
            ts * 1e3 + base - (unix + s.start - perf)))
        assert abs(got * 1e3 + base - (unix + s.start - perf)) < 1e6, s
        assert abs(got - rec.profiler_us(s.start)) < 1e3, s
