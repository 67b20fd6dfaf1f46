"""What a run makes from its seed: the weights, the images and the z-only
streams. Nothing here imports the program.

Weights: one ``torch.randn`` over every parameter at once, on the run's
device, from a ``torch.Generator`` seeded with the run's seed, in the
dtype the weights are served in. Each parameter takes its slice of the
draw in the sorted order of its name and is scaled as the seeded init of
the published model's random-weight runs scales it: a bias 0.1 x, a norm
weight 1 + 0.1 x, any other weight ``GAIN`` x / sqrt(fan in). The stream-rate
calibration then scales the y-path output heads of the codec by the
configuration's ``stream_scale``, so that a random codec writes y streams
in the released models' 0.02-0.15 bpp band (``calibration_heads``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

SEED_MASK = (1 << 63) - 1
# the scale of a weight that is neither a bias nor a norm weight, over
# sqrt(fan in): that of the published model's random-weight runs
GAIN = 0.5

# residual-branch terminal convs of the y path and the codec-relative
# prefixes of the stacks that feed the y quantiser
HEAD_NAMES = ("conv2", "adaptor", "conv_out", "nin_shortcut", "proj_out")
HEAD_PREFIXES = (
    ("enc", "unet", "conv_out"), ("enc", "tc_bottleneck"),
    ("enc", "tc_block0"), ("enc", "tc_block1"), ("y_prior_fusion",),
    ("y_spatial_prior",), ("y_spatial_prior_adaptor_1",),
    ("y_spatial_prior_adaptor_2",), ("y_spatial_prior_adaptor_3",),
    ("y_spatial_prior_reduction",),
)


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + salt) & SEED_MASK)
    return g


def calibration_head(name: str) -> bool:
    """True for a weight or bias that the stream-rate calibration scales."""
    path = tuple(name.split("."))
    if "codec" not in path:
        return False
    rel = path[path.index("codec") + 1:]
    for pref in HEAD_PREFIXES:
        if rel[:len(pref)] == pref:
            if pref[-1] in ("conv_out", "y_spatial_prior_reduction"):
                return True
            return any(n in rel for n in HEAD_NAMES)
    return False


@torch.no_grad()
def weights(shapes: Iterable[Tuple[str, torch.Size]], seed: int, device,
            dtype: torch.dtype, stream_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """name -> seeded tensor on ``device`` in ``dtype``."""
    shapes = sorted((n, torch.Size(s)) for n, s in shapes)
    total = sum(s.numel() for _, s in shapes)
    draw = torch.randn(total, generator=generator(seed, device, 1),
                       device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape in shapes:
        x = draw[at:at + shape.numel()].view(shape)
        at += shape.numel()
        if name.endswith("bias"):
            t = x * 0.1
        elif len(shape) == 1:
            t = x * 0.1 + 1.0
        else:
            t = x * (GAIN / shape[1:].numel() ** 0.5)
        if stream_scale != 1.0 and calibration_head(name):
            t = t * stream_scale
        out[name] = t
    return out


@torch.no_grad()
def images(seed: int, sizes, device, salt: int = 2) -> list:
    """One (1, h, w, 3) float32 image in [-1, 1] per (h, w): 32-pixel
    blocks of random colour and fine noise on top."""
    g = generator(seed, device, salt)
    out = []
    for h, w in sizes:
        coarse = torch.rand((1, -(-h // 32), -(-w // 32), 3), generator=g,
                            device=device) * 2 - 1
        coarse = coarse.repeat_interleave(32, 1).repeat_interleave(32, 2)
        fine = torch.rand((1, h, w, 3), generator=g, device=device) * 2 - 1
        out.append(0.8 * coarse[:, :h, :w] + 0.2 * fine)
    return out


def z_only_indices(seed: int, sizes, codebook: int, salt: int = 3) -> list:
    """One (1, H/64, W/64) int64 array of FSQ indices per (h, w), on the
    host."""
    g = generator(seed, "cpu", salt)
    return [torch.randint(0, codebook, (1, -(-h // 64), -(-w // 64)),
                          generator=g).numpy() for h, w in sizes]
