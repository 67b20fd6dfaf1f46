"""The numbers that ``correct`` compares, over many seeds in one process:
the readings a limit is set from.

    python3 benchmark/readings.py --workload NAME --seeds 1 2 3 \
        [--seconds S] [--variant w8a8] [--out FILE]

``--variant w8a8`` serves the decode in the program's own int8 mode, the
control of a bf16 configuration; ``--variant fp8_writer`` writes the lambda
pool under the indexes of the reference's prior in float8, the control of
the writer's indexes: their readings set a limit's upper end.
Each run prints one JSON line (seed, variant, checks, notes, the
end-to-end numbers); ``--out`` appends them to a file as well.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variant", default=None, choices=(None, "w8a8", "fp8_writer"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cell as cells

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        cell = cells.resolve(args.workload, seed, args.seconds, False)
        out, rec = cells.run(cell, device, time.perf_counter(),
                             {"variant": args.variant})
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "variant": args.variant or "program",
                           "correct": out["correct"],
                           "checks": out["checks"], "notes": rec["notes"],
                           "metrics": out["metrics"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del out, rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
