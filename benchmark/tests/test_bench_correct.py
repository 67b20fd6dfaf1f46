"""The comparison that decides ``correct``, run at the tiny geometry on the
CPU: the reference agrees with the port in float32, and each fault of the
timed path that a decode cell can have, and the int8 control, come out as
not correct in the configuration's bf16: the int8 control of the image,
and the float8 control of the writer's indexes."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests import tiny

CELLS = ("lambda_decode_kodak", "exlow_decode_kodak")


@pytest.mark.parametrize("workload", CELLS)
def test_the_reference_agrees_with_the_port(workload):
    out, rec = tiny.run(workload)
    # every image of the kept calls
    assert rec["notes"]["checked_images"] == 2 * 4
    assert max(e["rel_l2"] for e in rec["each"]) < 1e-4
    if workload.startswith("lambda"):
        assert out["checks"]["index_far_share"]["value"] == 0.0


def _half_left_out(images):
    """The second half of each call's answers never produced."""
    half = len(images) // 2
    return images[:half] + [torch.zeros_like(x) for x in images[half:]]


def _altered(images):
    """Every answer altered where it is produced."""
    return [x.flip(1) for x in images]


def _one_slot_altered(images):
    """The answer of one slot of each call altered."""
    return images[:-1] + [images[-1].flip(1)]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_half_left_out, _altered,
                                   _one_slot_altered])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    out, _ = tiny.run(workload, dtype="bfloat16", hooks={"fault": fault})
    assert not out["correct"], out["checks"]


def test_the_int8_control_is_not_correct(monkeypatch):
    # the tiny widths sit below the int8 mode's channel gate
    monkeypatch.setenv("ONEDC_Q8_MIN_CH", "0")
    ctl, _ = tiny.run("lambda_decode_kodak", dtype="bfloat16",
                      hooks={"variant": "w8a8"})
    out, _ = tiny.run("lambda_decode_kodak", dtype="bfloat16")
    assert not ctl["correct"], ctl["checks"]
    far = "far_pixel_share"
    assert ctl["checks"][far]["value"] > 5 * out["checks"][far]["value"]


def test_the_fp8_writer_control_is_not_correct():
    ctl, _ = tiny.run("lambda_decode_kodak", dtype="bfloat16",
                      hooks={"variant": "fp8_writer"})
    out, _ = tiny.run("lambda_decode_kodak", dtype="bfloat16")
    assert not ctl["correct"], ctl["checks"]
    for name in ("index_differ_share", "index_far_share"):
        assert ctl["checks"][name]["value"] > 3 * out["checks"][name][
            "value"], (name, ctl["checks"], out["checks"])
