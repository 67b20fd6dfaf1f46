"""Time ``utils/port_torch.py:merge_lora`` on the full-layout SD1.5 UNet
release (``tests/twins.py:sd_unet_twin``, rounded to F16 as the release
files hold it and read back in f32, as the loader does): on one thread
(its thread pool given one worker) and on its pool of 8, alternately,
with the merged tensors of the two checked equal bit for bit. Host work
only (numpy).

    python3 tools/time_lora_merge.py [--repeats N]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from onedc_tpu_torch.utils import port_torch  # noqa: E402
from twins import sd_unet_twin  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        card = "no GPU"
    t0 = time.perf_counter()
    state = {k: v.astype(np.float16).astype(np.float32)
             for k, v in sd_unet_twin().items()}
    n_lora = sum(v.size for k, v in state.items() if ".lora_" in k)
    print(f"UNet twin: {sum(v.size for v in state.values())} values, "
          f"{n_lora} of them LoRA adapters, in "
          f"{time.perf_counter() - t0:.2f} s; {os.cpu_count()} CPUs; {card}",
          flush=True)
    times = {1: [], 8: []}
    merged = {}
    for _ in range(args.repeats):
        for workers in (1, 8):
            # merge_lora's pool, with 1 or its own 8 workers
            port_torch.ThreadPoolExecutor = (
                lambda max_workers, n=workers: ThreadPoolExecutor(
                    min(n, max_workers)))
            t0 = time.perf_counter()
            merged[workers] = port_torch.merge_lora(state)
            times[workers].append(time.perf_counter() - t0)
    port_torch.ThreadPoolExecutor = ThreadPoolExecutor
    same = all(np.array_equal(merged[1][k], merged[8][k]) for k in merged[1])
    print("merge_lora seconds by workers " + json.dumps(times)
          + f"; same bits: {same}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
