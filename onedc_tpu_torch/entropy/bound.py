"""Differentiable bounds and quantization primitives.

JAX counterpart: ``onedc_tpu/entropy/bound.py:18-44``.
- ``lower_bound``: max(x, bound) whose gradient passes where x >= bound or
  where the incoming gradient is negative (it would push x up, towards the
  allowed side);
- ``ste_round``: rounding with an identity (straight-through) gradient;
- ``uniform_noise``: the training-time quantization proxy's noise,
  drawn from an explicit ``torch.Generator`` (``jax.random`` keys have no torch counterpart; the
  two give different numbers from the same seed).
"""

from __future__ import annotations

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x >= bound)
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (pass_through,) = ctx.saved_tensors
        return (pass_through | (g < 0)).to(g.dtype) * g, None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return _LowerBound.apply(x, bound)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through (identity) gradient."""
    return x + (torch.round(x) - x).detach()


def uniform_noise(shape, generator: torch.Generator, device, dtype,
                  noise_level: float = 0.5) -> torch.Tensor:
    """U(-noise_level, noise_level) of ``shape``, drawn from
    ``generator``."""
    noise = torch.rand(shape, generator=generator, device=device,
                       dtype=dtype)
    return noise * (2 * noise_level) - noise_level

