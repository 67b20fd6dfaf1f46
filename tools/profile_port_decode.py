"""Where the time of one full-width 768x768 decode of the PyTorch port
goes, on one card.

    python3 tools/profile_port_decode.py [--seed N] [--batch N]

Builds the full-width OneDC on seeded bf16 weights and one 768x768 stream
as ``chip_smoke.py`` does, warms up, then:
1. host wall ms of 5 decodes (median, min, max);
2. one decode under ``torch.profiler`` (CPU + CUDA): the window, the time
   the device was busy with at least one kernel (the union of the kernel
   intervals), and device time by kernel family and by kernel name.
With ``--batch N``: N seeded 768x768 images encoded with the weights
calibrated as ``chip_smoke.py``'s serving phase does
(``pick_stream_scale``), and one pipelined ``decode_batch`` of the N
streams profiled at the defaults and one at ``ONEDC_PIPELINE_DEPTH=1``
(after a warm pass of each), in place of 1-2.
Prints one JSON object as its last line.
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

FAMILIES = (
    ("K1 flash_attention", ("flash_fwd_kernel",)),
    ("K2 gn_silu_conv3x3", ("gn_silu_conv3x3_kernel",)),
    ("cuDNN/cuBLAS conv+gemm", ("conv", "gemm", "xmma", "cutlass", "sm90",
                                "implicit", "cudnn", "nchw", "nhwc")),
    ("reductions", ("reduce", "norm", "softmax")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise/other"


def union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profiled(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: the host window to a
    synchronised device, device busy ms, idle share, kernel launches and
    device ms by family and by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_family, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_family[family(e.name)] = by_family.get(family(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    busy_ms = union_us(intervals) / 1e3 if intervals else 0.0
    return {
        "profiled_window_ms": window_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / window_ms if window_ms else None,
        "kernel_launches": len(kernels),
        "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])},
        "device_ms_top_kernels": [[n[:90], v / 1e3] for n, v in top],
    }


def batch_profiles(rt, n: int, seed: int) -> dict:
    """The pipelined decode_batch of n calibrated 768x768 streams,
    profiled at the defaults and at depth 1."""
    images = next(chip_smoke.synthetic_batches(seed + 3, n, 768))["image"]
    images = [im[None] for im in images]
    base = {k: v.clone() for k, v in rt.model.state_dict().items()}
    scale, bpp = chip_smoke.calibrate(rt, images[0], base)
    del base
    streams = [s for s, _ in rt.encode_many(images)]
    out = {"streams": n, "calibration_scale": scale, "bpp_y": bpp}
    for name, depth in (("defaults", None), ("depth1", "1")):
        if depth is not None:
            os.environ["ONEDC_PIPELINE_DEPTH"] = depth
        try:
            rt.decode_batch(streams)
            out[name] = profiled(lambda: rt.decode_batch(streams))
        finally:
            os.environ.pop("ONEDC_PIPELINE_DEPTH", None)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=0,
                        help="profile a pipelined decode_batch of this many "
                             "calibrated 768x768 streams instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_decode: no CUDA device", file=sys.stderr)
        return 1
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime
    from onedc_tpu_torch.ops import build

    card = chip_smoke.card_line()
    build.build_all()
    with torch.device("cuda"):
        model = OneDC()
    chip_smoke.init_random_weights(model, args.seed)
    rt = OneDCRuntime(model, dtype=torch.bfloat16)
    if args.batch:
        print(json.dumps({"card": card, "decode_batch": batch_profiles(
            rt, args.batch, args.seed)}))
        return 0
    stream = chip_smoke.write_synthetic_stream(rt, 768, 768, args.seed)[0]

    for _ in range(2):
        rt.decode(stream)
    torch.cuda.synchronize()
    wall = []
    for _ in range(5):
        t0 = time.perf_counter()
        rt.decode(stream)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    result = {
        "card": card,
        "decode_wall_ms": {"median": statistics.median(wall),
                           "min": min(wall), "max": max(wall), "n": 5},
        **profiled(lambda: rt.decode(stream)),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    from onedc_tpu_torch.utils.numerics import pinned_numerics

    with pinned_numerics():
        sys.exit(main())
