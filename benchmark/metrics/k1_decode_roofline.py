"""K1's share of its roofline in a decode: the least time the attention
that the flash kernel takes (both sequences at least 2048 and multiples
of 128; ``harness/work.py:attention_bound``, bf16) in the traced call's
images could take, over the device time of the kernels whose names hold
``KERNELS``."""

KERNELS = ("flash_fwd_kernel",)


def read(ctx):
    t, w = ctx["trace"], ctx["work"]
    if t is None or not w:
        return None
    spent = sum(d for n, _, d in t.kernels if any(k in n for k in KERNELS))
    if spent <= 0 or w["k1_bound_s"] <= 0:
        return None
    return 100.0 * w["k1_bound_s"] * ctx["images"] / spent
