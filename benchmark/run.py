"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the result as one JSON object on the last line of standard output,
and each number compared for ``correct`` beside its limit as the last
lines of standard error. Exits non-zero, with no result, without CUDA or
with fewer cards than the cell asks for, if the program cannot be
imported, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cell as cells

    cell = cells.resolve(args.workload, args.seed, args.seconds,
                         bool(args.trace))
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s), this "
              f"machine has {n}", file=sys.stderr)
        return 2
    print("card: " + card_line(), file=sys.stderr, flush=True)
    out, rec = cells.run(cell, torch.device("cuda", 0), T_START)
    found = cells.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for key, value in rec["notes"].items():
        print(f"note {key} {value!r}", file=sys.stderr)
    for name, chk in out["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


def card_line() -> str:
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


if __name__ == "__main__":
    sys.exit(main())
