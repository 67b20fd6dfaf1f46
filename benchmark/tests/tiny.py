"""The tiny geometry the CPU tests run the cells at: the published model's
structure with 32-divisible widths, and a call of four small images."""

from __future__ import annotations

import time

import torch

from benchmark.harness import cell as cells

MODEL = dict(internal_ch=64, bottleneck_ch=32, unet_ch_config=[32, 64, 64],
             ctrl_ch=32, sd_block_channels=[32, 32, 64, 64], context_dim=64,
             vae_block_channels=[32, 32, 64, 64], vae_attn_patch=4)
TRAFFIC = {"call": [[64, 128, 3], [128, 64, 1]], "pool_calls": 2,
           "warm_calls": 1, "checked_calls": 2}


def run(workload: str, seed: int = 12345678901, dtype: str = "float32",
        trace: bool = False, hooks=None, seconds: float = 0.5):
    """One run of ``workload`` on the CPU at the tiny geometry: (result
    object, runner record)."""
    model = dict(MODEL, z_only=workload.startswith("exlow"))
    cell = cells.resolve(workload, seed, seconds, trace,
                         config_override={"model": model,
                                          "decode_dtype": dtype},
                         traffic_override=TRAFFIC)
    torch.set_num_threads(2)
    return cells.run(cell, torch.device("cpu"), time.perf_counter(), hooks)
