"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the
program."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark.harness import cell as cells

PROGRAM = "onedc_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in cells.BENCH.rglob("*.py"):
        names = set(_imports(path))
        assert not names & set(cells.FORBIDDEN), path
        if "reference" in path.parts:
            assert PROGRAM not in names, path


def test_a_run_loads_neither(tmp_path):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests import tiny\n"
        "tiny.run('lambda_decode_kodak')\n"
        "from benchmark.harness import cell\n"
        "assert 'onedc_tpu_torch' in sys.modules\n"
        "print(cell.forbidden_modules())\n" % str(cells.ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "TMPDIR": str(tmp_path)})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        return
    res = subprocess.run([sys.executable, str(cells.BENCH / "run.py"),
                          "--workload", "exlow_decode_kodak", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()
