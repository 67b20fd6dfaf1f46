"""Differentiable bounds and quantization primitives.

JAX counterpart: ``onedc_tpu/entropy/bound.py:18-44``.
- ``lower_bound``: max(x, bound) whose gradient passes where x >= bound or
  where the incoming gradient is negative (it would push x up, towards the
  allowed side);
- ``ste_round``: rounding with an identity (straight-through) gradient;
- ``add_uniform_noise``: the training-time quantization proxy, drawing its
  noise from an explicit ``torch.Generator`` (``jax.random`` keys have no
  torch counterpart; the two give different numbers from the same seed).
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


def add_uniform_noise(x: torch.Tensor, generator: torch.Generator,
                      noise_level: float = 0.5) -> torch.Tensor:
    """x + U(-noise_level, noise_level), the noise drawn from ``generator``
    on x's device and carrying no gradient."""
    noise = torch.rand(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)
    return x + (noise * (2 * noise_level) - noise_level)
