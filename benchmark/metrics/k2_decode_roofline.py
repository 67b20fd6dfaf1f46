"""K2's share of its roofline in a decode: the least time the VAE resnet
blocks' GroupNorm + SiLU + 3x3 convs of the traced call's images could
take (``harness/work.py:conv_bound``, bf16) over the device time of the
kernels whose names hold ``KERNELS``."""

KERNELS = ("gn_silu_conv3x3",)


def read(ctx):
    t, w = ctx["trace"], ctx["work"]
    if t is None or not w:
        return None
    spent = sum(d for n, _, d in t.kernels if any(k in n for k in KERNELS))
    if spent <= 0 or w["k2_bound_s"] <= 0:
        return None
    return 100.0 * w["k2_bound_s"] * ctx["images"] / spent
