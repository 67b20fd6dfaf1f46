"""Exponential moving average of parameters.

JAX counterpart: ``onedc_tpu/train/ema.py`` (``ema_init``, ``ema_update``
:14-21), on state dicts: ``{name: tensor}``. No trainer uses it, in
either package.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def ema_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A detached copy of ``params``."""
    return {k: v.detach().clone() for k, v in params.items()}


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor],
               new_params: Mapping[str, torch.Tensor],
               decay: float = 0.999) -> Dict[str, torch.Tensor]:
    """``e * decay + p * (1 - decay)`` per name, ``p`` in ``e``'s dtype."""
    return {k: e * decay + new_params[k].to(e.dtype) * (1.0 - decay)
            for k, e in ema_params.items()}
