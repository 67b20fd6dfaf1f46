"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel's work could take, and the work one decode of the configuration
needs, counted on the plain reference from its shapes.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit. The
exponential rate is the SFU's: 132 SMs x 16 per clock x 1.83 GHz.
Bounds: each input byte read once and each output byte written once,
whatever a kernel reads again (``conv_bound``: K2, GroupNorm affine + SiLU
+ 3x3 conv; ``attention_bound``: K1, the flash attention forward).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12
EXP_PER_S = 132 * 16 * 1.83e9

# the shapes a kernel takes: K1 both sequences >= 2048 and multiples of 128
FLASH_MIN_SEQ = 2048
FLASH_LANE = 128


def bound_s(flops: float, nbytes: float, exps: float = 0.0) -> float:
    """The least seconds the card could take: the largest of the
    operations, the bytes and the exponentials over their peak rates."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES, exps / EXP_PER_S)


def conv_bound(b, h, w, cin, cout, itemsize) -> float:
    """K2 on (b, h, w, cin) -> (b, h, w, cout): 18 b h w cin cout FLOPs;
    x, y, the 3x3 weights, the bias and the f32 (mul, add) affine."""
    nbytes = (b * h * w * (cin + cout) * itemsize + 9 * cin * cout * itemsize
              + 2 * b * cin * 4 + cout * itemsize)
    return bound_s(18.0 * b * h * w * cin * cout, nbytes)


def attention_bound(b, n, h, d, m, itemsize) -> float:
    """K1 forward on (b, n, h, d) queries and m keys: 4 b h n m d FLOPs,
    b h n m exponentials, q, k, v and o moved once."""
    return bound_s(4.0 * b * h * n * m * d,
                   2 * b * (n + m) * h * d * itemsize, float(b) * h * n * m)


def flash_route(n: int, m: int) -> bool:
    return n % FLASH_LANE == 0 and m % FLASH_LANE == 0 \
        and min(n, m) >= FLASH_MIN_SEQ


@torch.no_grad()
def decode_work(model_cfg: dict, height: int, width: int, z_only: bool
                ) -> Dict[str, float]:
    """The work of one decode of an ``height`` x ``width`` image (padded to
    64), counted on the plain reference on the meta device: "flops" (the
    prior nets, codec finish, UNet and VAE decoder; products counted by
    ``FlopCounterMode``), "k1_bound_s" and "k2_bound_s" (the least time of
    the attention and of the VAE resnet convs that the kernels take, in
    bf16)."""
    from ..reference import model as ref

    itemsize = 2
    ph, pw = -(-height // 64) * 64, -(-width // 64) * 64
    with torch.device("meta"):
        dec = ref.OneDCDecoder(model_cfg)
        z = torch.zeros((1, ph // 64, pw // 64), dtype=torch.long)
    ref.attention_log, ref.conv_log = [], []
    try:
        counter = FlopCounterMode(display=False)
        with counter:
            sym = (None if z_only else
                   (lambda step, scales: torch.zeros_like(scales)))
            y_hat, z_sem, _ = dec.codec.prior(z, sym)
            dec.image(y_hat, z_sem)
        att, conv = ref.attention_log, ref.conv_log
    finally:
        ref.attention_log, ref.conv_log = None, None
    k1 = sum(attention_bound(b, n, h, d, m, itemsize)
             for b, n, h, d, m in att if flash_route(n, m))
    k2 = sum(conv_bound(b, h, w, cin, cout, itemsize)
             for b, h, w, cin, cout in conv)
    return {"flops": float(counter.get_total_flops()), "k1_bound_s": k1,
            "k2_bound_s": k2}
