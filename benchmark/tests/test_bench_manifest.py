"""BENCHMARK.json against the contract's form, and every cell's files
found by name."""

from __future__ import annotations

import json
import re

from benchmark.harness import cell as cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_./-]+$")


def test_names_units_and_keys():
    man = cells.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names.append(w["name"])
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(names) == len(set(names))
    assert len(json.dumps(man)) < 64 * 1024


def test_every_cell_resolves_its_files_by_name():
    man = cells.manifest()
    for w in man["workloads"]:
        cell = cells.resolve(w["name"], 1, 1.0, False)
        assert cell.config["name"] == w["config"]
        assert (cells.BENCH / "harness" / f"{cell.traffic['runner']}.py"
                ).exists()
    for m in man["per_layer"]:
        assert callable(cells.reader(m["name"]))
    for path in cells.BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert FILE.match(str(path.relative_to(cells.ROOT)))


def test_config_files_state_their_cuts():
    man = cells.manifest()
    for c in man["configs"]:
        conf = json.loads((cells.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert all(k in conf for k in c["reduced"])
        assert conf["assumed"] and conf["limits"]
