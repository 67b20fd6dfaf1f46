"""One run of one cell: resolve the cell's files by name, run its traffic's
runner, read the per-layer metrics and assemble the result line.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration
(``configs/<config>.json``, by the ``file`` of its ``configs`` entry) and a
traffic mix (``traffic/<traffic>.json``), whose ``runner`` names the
module of this package that runs it. Each per-layer metric is a reader in
``metrics/<name>.py`` with ``read(ctx) -> float | None``, where ``ctx`` is
the runner's record's ``ctx`` of a ``--trace 1`` run.

A runner's ``run(cell, device, t_start, hooks)`` returns a record with
``e2e`` (every end-to-end metric of the cell by name), ``checks`` ((name,
value, limit) of each number compared), ``correct``, ``attempted``,
``failed``, ``peak_bytes``, ``notes`` (printed to standard error), and in
a traced run ``ctx`` (with ``trace``, a ``harness/trace.py:Trace``) and
``idle_gaps``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import NamedTuple, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "onedc_tpu")


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    manifest: dict


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def resolve(name: str, seed: int, seconds: float, trace: bool,
            config_override: Optional[dict] = None,
            traffic_override: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its files read; the overrides replace keys
    of the configuration and of the traffic (the tests' tiny sizes)."""
    man = manifest()
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    if config_override:
        config = {**config, **config_override}
    traffic = json.loads((BENCH / "traffic"
                          / f"{w['traffic']}.json").read_text())
    traffic = {**traffic, **(traffic_override or {})}
    return Cell(name, config, traffic, int(w["chips"]), int(seed),
                float(seconds), bool(trace), man)


def metrics_of(cell: Cell, kind: str):
    """The ``kind`` ("end_to_end" or "per_layer") metrics the cell reports."""
    return [m for m in cell.manifest[kind]
            if "workloads" not in m or cell.name in m["workloads"]]


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(cell: Cell, device, t_start: float, hooks=None) -> dict:
    """The result line's object and the numbers compared."""
    runner = importlib.import_module(
        f"benchmark.harness.{cell.traffic['runner']}")
    rec = runner.run(cell, device, t_start, hooks)
    if cell.trace:
        metrics = {}
        for m in metrics_of(cell, "per_layer"):
            value = reader(m["name"])(rec["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": rec["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in metrics_of(cell, "end_to_end")}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": _device_kind(device), "count": cell.chips,
                   "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": bool(rec["correct"]), "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics,
           "device": device_info}
    if cell.trace:
        t = rec["ctx"]["trace"]
        device_info["busy_s"] = t.busy_s
        device_info["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                            "idle_gaps": [list(x) for x in rec["idle_gaps"]]}
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in rec["checks"]}
    return out, rec


def _device_kind(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
