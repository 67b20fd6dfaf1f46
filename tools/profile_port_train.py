"""Where the time of one full-width stage-I training step of the PyTorch
port goes, on one card.

    python3 tools/profile_port_train.py [--seed N]

Builds the ``Trainer`` as the training phase of ``chip_smoke.py`` does
(``configs/train_stage1.yaml`` with ``chip_smoke.TRAIN_OVERRIDES``, seeded
random f32 weights, seeded synthetic 1024x1024 images, TF32 off), and for
each configured resolution (512x512 at batch 2, 768x768 at batch 1):
1. one warm-up step, then host wall ms of 3 steps (each ends in a
   synchronise) and the peak device memory over them;
2. one step under ``torch.profiler`` (CPU + CUDA): the window, the time the
   device was busy with at least one kernel (the union of the kernel
   intervals), the idle share, and device time by kernel family and by
   kernel name.
Prints one JSON object per resolution, and the card line last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from profile_port_decode import union_us  # noqa: E402

FAMILIES = (
    ("K1 flash_attention fwd", ("flash_fwd_kernel",)),
    ("K1-bwd flash_attention bwd", ("flash_bwd_",)),
    ("AdamW (foreach)", ("multi_tensor_apply", "foreach")),
    ("cuDNN/cuBLAS conv+gemm", ("conv", "gemm", "xmma", "cutlass", "sm90",
                                "implicit", "cudnn", "nchw", "nhwc")),
    ("reductions", ("reduce", "norm", "softmax")),
)


def family(name: str) -> str:
    # before FAMILIES, whose "conv" key would take them: the kernels of
    # csrc/conv3x3.cu, K2 (gn_silu_conv3x3_kernel_wgmma, _f32 in training)
    # and K3 (conv3x3_dx_kernel_wgmma)
    if "conv3x3_dx_kernel" in name:
        return "K3 conv3x3"
    if "gn_silu_conv3x3_kernel" in name:
        return "K2 gn_silu_conv3x3"
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise/other"


def profile_step(trainer, step: int) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_one_step(step)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_family, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_family[family(e.name)] = by_family.get(family(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_ms = union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "profiled_window_ms": window_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / window_ms,
        "kernel_launches": len(kernels),
        "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])},
        "device_ms_top_kernels": [[n[:100], v / 1e3] for n, v in top],
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_train: no CUDA device", file=sys.stderr)
        return 1
    from onedc_tpu_torch.config import load_config
    from onedc_tpu_torch.ops import build
    from onedc_tpu_torch.train.trainer import Trainer

    card = chip_smoke.card_line()
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = load_config("configs/train_stage1.yaml", chip_smoke.TRAIN_OVERRIDES)
    trainer = Trainer(cfg, device="cuda", batches=chip_smoke.synthetic_batches(
        args.seed, cfg["batch_size"]))
    chip_smoke.init_random_weights(trainer.model, args.seed)

    picks = {s: trainer.crop.pick(s) for s in range(64)}
    for res in cfg["resolutions"]:
        steps = [s for s, (r, _) in picks.items() if r == res][:5]
        trainer.train_one_step(steps[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wall = []
        for step in steps[1:4]:
            t0 = time.perf_counter()
            trainer.train_one_step(step)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        batch = max(1, int(round(cfg["batch_size"] * picks[steps[0]][1])))
        result = {"resolution": res, "batch": batch,
                  "step_wall_ms": {"median": statistics.median(wall),
                                   "all": wall},
                  "peak_device_gib": peak,
                  **profile_step(trainer, steps[4])}
        print(json.dumps(result), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
