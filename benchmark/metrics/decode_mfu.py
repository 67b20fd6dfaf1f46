"""The whole decode's share of the card's bf16 dense peak: the products
one decode of the traffic's images needs (counted on the plain reference,
``harness/work.py``) times the images of the window's calls that ran
without the profiler, over those calls' seconds on the host's clock, the
device synchronised after each, against 989 TFLOP/s."""

from benchmark.harness import work


def read(ctx):
    w = ctx["work"]
    if not w or not ctx["untraced_images"] or ctx["untraced_s"] <= 0:
        return None
    return 100.0 * w["flops"] * ctx["untraced_images"] / (
        ctx["untraced_s"] * work.BF16_FLOPS)
