"""The reading of a profiler trace, on events written by hand, and a
traced run at the tiny geometry on the CPU."""

from __future__ import annotations

import pytest

from benchmark.harness import trace
from benchmark.tests import tiny


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _ev(trace.MARK, "user_annotation", 0.0, 1000.0),
    _ev("gemm", "kernel", 100.0, 200.0),
    _ev("gemm", "kernel", 250.0, 100.0),        # overlaps the first
    _ev("Memcpy DtoH", "gpu_memcpy", 500.0, 50.0),
    _ev("aten::conv2d", "cpu_op", 380.0, 100.0),
    _ev("aten::copy_", "cpu_op", 600.0, 400.0),
    _ev("aten::mul", "cpu_op", 700.0, 200.0),
]


def test_busy_time_is_the_union_of_device_intervals():
    t = trace.read(EVENTS, 0.001)
    assert t.window_s == 0.001
    assert t.busy_s == pytest.approx((250 + 50) * 1e-6)
    assert [k[0] for k in t.kernels] == ["gemm", "gemm"]
    assert t.device_ops[0] == ("gemm", pytest.approx(300e-6))


def test_idle_gaps_are_named_by_the_innermost_host_op():
    gaps = trace.gaps_of(EVENTS)
    # [550, 1000], [350, 500], [0, 100], longest first
    assert [g[0] for g in gaps] == ["aten::mul", "aten::conv2d",
                                    "no host op"]
    assert [g[1] for g in gaps] == pytest.approx([450e-6, 150e-6, 100e-6])


@pytest.mark.parametrize("workload", ["lambda_decode_kodak",
                                      "exlow_decode_kodak"])
def test_a_traced_run_gives_its_line(workload):
    out, rec = tiny.run(workload, trace=True)
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0
    # the profiled calls are left out of the rate the model step reads
    assert rec["ctx"]["untraced_images"] == (rec["notes"]["calls"] - 3) * 4
    assert len(rec["notes"]["call_s"]) == rec["notes"]["calls"] - 3
    assert "far_pixel_share" in out["checks"]


def test_idle_share_is_against_the_unprofiled_calls():
    from benchmark.harness import cell as cells

    t = trace.Trace(window_s=2.0, busy_s=0.5, kernels=[], device_ops=[])
    idle = cells.reader("idle_pct.decode")
    assert idle({"trace": t, "call_s": [1.0, 1.0, 3.0]}) == pytest.approx(
        50.0)
    assert idle({"trace": None, "call_s": [1.0]}) is None
