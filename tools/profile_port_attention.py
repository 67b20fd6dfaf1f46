"""Device time of the training path's attention kernels of the PyTorch
port, on one card: K1 in f32 with the row log-sum-exp and K1-bwd.

    python3 tools/profile_port_attention.py [--seed N] [--label L]

Builds the kernels, then for each shape of ``chip_smoke.K1_TRAIN_SHAPES``
times one launch of each (``chip_smoke.cuda_ms``: CUDA events over 20
back-to-back launches after a warm-up) on seeded f32 inputs, and prints
one ``TIME`` line per shape (with ``--label``, to tell apart trees timed
in one call) and the card line last. No check of the results:
``chip_smoke.py`` holds the kernels against their plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_attention: no CUDA device", file=sys.stderr)
        return 1
    from onedc_tpu_torch.ops import build
    from onedc_tpu_torch.ops import flash_attention as k1

    card = chip_smoke.card_line()
    for name in ("flash_attention", "flash_attention_bwd"):
        build.build_cuda(name)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for bucket, shapes in chip_smoke.K1_TRAIN_SHAPES.items():
        for shape, count in shapes:
            d = shape[-1]
            q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda")
                             for _ in range(4))
            out, lse = k1.flash_attention_cuda(q, k, v, d ** -0.5,
                                               with_lse=True)
            di = (out * dout).sum(-1).transpose(1, 2).contiguous()
            fwd = chip_smoke.cuda_ms(lambda: k1.flash_attention_cuda(
                q, k, v, d ** -0.5, with_lse=True), iters=20)
            bwd = chip_smoke.cuda_ms(lambda: k1.flash_attention_bwd_cuda(
                q, k, v, dout, lse, di, d ** -0.5), iters=20)
            print("TIME " + json.dumps({
                "label": args.label, "bucket": bucket, "shape": list(shape),
                "count": count, "k1_f32_ms": fwd, "k1_bwd_ms": bwd}),
                flush=True)
            del q, k, v, dout, out, lse, di
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
