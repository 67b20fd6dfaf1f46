"""Four-part (quadtree) spatial-channel prior: masks, the training /
eval forward and the staged decode helpers.

JAX counterpart: ``onedc_tpu/entropy/fourpart.py`` (:32-57, :68-126,
:165-175). The latent y is coded in 4 interleaved steps; each step covers
one (checkerboard phase x channel quarter) combination. Arrays are NHWC, as
in the JAX package, because they cross the host boundary of the decode
loop.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .bound import ste_round

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


def process_with_mask(y, scales, means, mask, force_zero_thres=None,
                      training: bool = True):
    """One step's masked residual, its rounding (straight-through in
    training), y_hat and scales; (y_res, y_q, y_hat, scales_hat)."""
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = ste_round(y_res) if training else torch.round(y_res)
    if not training and force_zero_thres is not None:
        cond = scales_hat < force_zero_thres
        y_q = torch.where(cond, torch.zeros_like(y_q), y_q)
        scales_hat = torch.where(cond, torch.zeros_like(scales_hat),
                                 scales_hat)
    return y_res, y_q, y_q + means_hat, scales_hat


def forward_four_part_prior(y, common_params,
                            prior_steps: Sequence[Callable],
                            reduction: Optional[Callable] = None, *,
                            training: bool = True, force_zero_thres=None):
    """The training / eval four-step masked coding of y (NHWC; the JAX
    package's ``write=False`` branch). ``prior_steps`` are three callables
    (adaptor_i then the spatial prior) on NHWC params; the first step uses
    the hyperprior params directly. Returns (y_res, y_q, y_hat,
    scales_hat), each summed over the 4 steps."""
    scales, means = separate_prior(common_params)
    if reduction is not None:
        common_params = reduction(common_params)
    _, h, w, c = y.shape
    masks = four_part_masks(h, w, c, y.dtype, y.device)
    results = []
    y_hat_so_far = torch.zeros_like(y)
    for step in range(4):
        if step > 0:
            params = torch.cat([y_hat_so_far, common_params], dim=-1)
            scales, means = separate_prior(prior_steps[step - 1](params))
        r = process_with_mask(y, scales, means, masks[step],
                              force_zero_thres, training)
        results.append(r)
        y_hat_so_far = y_hat_so_far + r[2]
    y_res, y_q, _, scales_hat = (sum(parts) for parts in zip(*results))
    return y_res, y_q, y_hat_so_far, scales_hat
