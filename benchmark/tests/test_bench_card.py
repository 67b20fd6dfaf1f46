"""One short run of each cell on the card, through the command; skips
without a CUDA card (``python -m pytest benchmark/tests -m cuda`` on the
chip)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness import cell as cells


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cells.manifest()["workloads"]])
def test_a_short_run_is_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, str(cells.BENCH / "run.py"),
                          "--workload", workload, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200,
                         cwd=cells.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,variant", [
    ("exlow_decode_kodak", "w8a8"), ("lambda_decode_kodak", "fp8_writer")])
def test_a_control_is_not_correct_on_the_card(workload, variant):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, str(cells.BENCH / "readings.py"),
                          "--workload", workload, "--seeds",
                          "2147483661", "--seconds", "2", "--variant",
                          variant], capture_output=True, text=True,
                         timeout=1200, cwd=cells.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"] is False
