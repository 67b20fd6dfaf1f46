"""Diffusion schedule and x0 recovery for the one-step generator.

JAX counterpart: ``onedc_tpu/nn/diffusion.py``. SD1.5 ``scaled_linear``
betas in [0.00085, 0.012] over 1000 steps. x0 is recovered in f32, not the
reference's f64: alpha_bar(999) ~ 4.7e-3 only rescales, so f32 keeps full
relative precision (the JAX package's documented deviation).
"""

from __future__ import annotations

import numpy as np
import torch


def make_alphas_cumprod(num_train_timesteps: int = 1000,
                        beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    """SD1.5 scaled_linear schedule, in float64 on the host."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def get_x0_from_noise(sample, eps, alphas_cumprod, timestep):
    """x0 = (sample - sqrt(1 - abar) * eps) / sqrt(abar), in f32.
    ``timestep``: (B,) integer tensor."""
    table = torch.as_tensor(np.asarray(alphas_cumprod, np.float32),
                            device=sample.device)
    abar = table[timestep.long()].reshape(-1, 1, 1, 1)
    return (sample.float() - torch.sqrt(1.0 - abar) * eps.float()) \
        / torch.sqrt(abar)
