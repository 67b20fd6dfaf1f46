"""Rate-distortion training losses.

JAX counterpart: ``onedc_tpu/train/losses.py``: pixel L1 / MSE + LPIPS +
lambda * bpp with a quadratic-ramp lambda schedule. With ``lpips_fn=None``
the LPIPS term is 0 (the trainer's ``allow_no_lpips``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def lambda_schedule(step, start_step: float, end_step: float,
                    start_value: float, end_value: float) -> float:
    """start + clip((step - t0) / (t1 - t0), 0, 1) ** 2 * (end - start),
    in f32 as the JAX package computes it."""
    t = torch.tensor(float(step), dtype=torch.float32)
    factor = torch.clamp((t - start_step) / (end_step - start_step), 0.0, 1.0)
    value = start_value + factor ** 2 * (end_value - start_value)
    return float(value.to(torch.float32))


class RDLoss:
    """pix + LPIPS + lambda * bpp."""

    def __init__(self, pix_weight: float = 1.0, lpips_weight: float = 1.0,
                 lmbda: float = 1.8, lmbda_schedule: Optional[dict] = None,
                 pix_loss_type: str = "l1",
                 lpips_fn: Optional[Callable] = None):
        if pix_loss_type not in ("l1", "mse"):
            raise ValueError(f"pix_loss_type {pix_loss_type!r}")
        self.pix_weight = pix_weight
        self.lpips_weight = lpips_weight
        self.lmbda = lmbda
        self.lmbda_schedule = lmbda_schedule
        self.pix_loss_type = pix_loss_type
        self.lpips_fn = lpips_fn

    def __call__(self, x, x_hat, bpp, step=None, norm01: bool = True,
                 training: bool = True) -> Tuple[torch.Tensor, Dict]:
        if norm01:  # [-1, 1] -> [0, 1]
            x = x * 0.5 + 0.5
            x_hat = x_hat * 0.5 + 0.5
        if self.pix_loss_type == "l1":
            l_pix = (x - x_hat).abs().mean()
        else:
            l_pix = ((x - x_hat) ** 2).mean()
        l_weighted_pix = l_pix * self.pix_weight
        if self.lpips_fn is not None:
            l_lpips = self.lpips_fn(x, x_hat).mean()
        else:
            l_lpips = torch.zeros((), device=x.device)
        l_weighted_lpips = l_lpips * self.lpips_weight
        if step is not None and self.lmbda_schedule and training:
            lmbda = lambda_schedule(step, **self.lmbda_schedule)
        else:
            lmbda = float(self.lmbda)
        l_weighted_bpp = bpp * lmbda
        distortion = l_weighted_pix + l_weighted_lpips
        loss = distortion + l_weighted_bpp
        return loss, {
            "pix": l_pix,
            "lpips": l_lpips,
            "bpp": bpp,
            "weighted_pix": l_weighted_pix,
            "weighted_lpips": l_weighted_lpips,
            "distortion": distortion,
            "weighted_bpp": l_weighted_bpp,
            "lmbda": torch.tensor(lmbda),
            "total_loss": loss,
        }
