"""Four-part (quadtree) spatial-channel prior: masks and the staged
decode helpers.

JAX counterpart: ``onedc_tpu/entropy/fourpart.py`` (:32-57, :165-175).
The latent y is coded in 4 interleaved steps; each step covers one
(checkerboard phase x channel quarter) combination. Arrays are NHWC, as in
the JAX package, because they cross the host boundary of the decode loop.
"""

from __future__ import annotations

import torch

# step -> channel quarter -> spatial phase (phase = 2*(h%2) + (w%2))
_PHASE_PERM = (
    (0, 1, 2, 3),
    (3, 2, 1, 0),
    (2, 3, 0, 1),
    (1, 0, 3, 2),
)


def four_part_masks(height: int, width: int, channels: int,
                    dtype=torch.float32, device=None):
    """The 4 coding masks, each (1, H, W, C)."""
    if channels % 4:
        raise ValueError(f"channels {channels} not a multiple of 4")
    h_ids = torch.arange(height, device=device)[:, None]
    w_ids = torch.arange(width, device=device)[None, :]
    phase = (h_ids % 2) * 2 + (w_ids % 2)  # (H, W)
    quarter = torch.arange(channels, device=device) // (channels // 4)
    perm = torch.as_tensor(_PHASE_PERM, device=device)
    want = perm[:, quarter]  # (4 steps, C)
    masks = (phase[None, :, :, None] == want[:, None, None, :]).to(dtype)
    return tuple(masks[s][None] for s in range(4))


def combine_quarters(x: torch.Tensor) -> torch.Tensor:
    """Sum the 4 channel quarters -> (B, H, W, C/4)."""
    x0, x1, x2, x3 = torch.chunk(x, 4, dim=-1)
    return (x0 + x1) + (x2 + x3)


def tile_quarters(x: torch.Tensor) -> torch.Tensor:
    """Inverse layout of combine_quarters: repeat C/4 -> C channels."""
    return torch.cat([x, x, x, x], dim=-1)


def separate_prior(params: torch.Tensor):
    """(..., 2C) -> (scales, means)."""
    return torch.chunk(params, 2, dim=-1)


def decompress_step_update(y_q_r, means, mask, y_hat_so_far):
    y_hat_curr = (tile_quarters(y_q_r) + means) * mask
    return y_hat_so_far + y_hat_curr
