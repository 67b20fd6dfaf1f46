"""Factorized (non-conditional) prior, the BitEstimator, and its coder.

JAX counterpart: ``onedc_tpu/entropy/factorized.py`` (the reference's
``entropy_models.py:97-249``). A 4-layer monotone density model per
channel over NHWC input; the parameters keep the flax names
(``Bitparm_<i>.h``, ``.b``, ``.a``, each (1, 1, 1, C)), so a flax tree
carries across key for key (``state_dict_from_flax``). Unused by the
shipped OneDC paths (z is FSQ-coded), as in the JAX package; stock torch,
no hand kernel (JAX has none either). ``FactorizedCoder`` builds the
quantized CDF table on the host from the module evaluated on the device
of its parameters, and codes through the port's rANS coder.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..ops.rans import pmf_to_quantized_cdf
from .bound import lower_bound
from .coder import EntropyCoder


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0)), with
    # no linear cut-off above a threshold as torch.nn.functional.softplus has
    return torch.logaddexp(x, torch.zeros_like(x))


class Bitparm(nn.Module):
    def __init__(self, channels: int, final: bool = False):
        super().__init__()
        self.final = final
        shape = (1, 1, 1, channels)
        self.h = nn.Parameter(torch.empty(shape).normal_(0.0, 0.01))
        self.b = nn.Parameter(torch.empty(shape).normal_(0.0, 0.01))
        if not final:
            self.a = nn.Parameter(torch.empty(shape).normal_(0.0, 0.01))

    def forward(self, x):
        x = x * _softplus(self.h) + self.b
        if self.final:
            return x
        return x + torch.tanh(x) * torch.tanh(self.a)


class BitEstimator(nn.Module):
    """CDF model over the integers for ``channels`` latent channels (NHWC,
    channels last)."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        for i in range(4):
            self.add_module(f"Bitparm_{i}", Bitparm(channels, final=i == 3))

    def forward(self, x, mode: str = "cdf"):
        for i in range(4):
            x = getattr(self, f"Bitparm_{i}")(x)
        return x if mode == "logits" else torch.sigmoid(x)

    def prob(self, x):
        """The training-time probability of the integer bucket around x."""
        lower = self(x - 0.5, mode="logits")
        upper = self(x + 0.5, mode="logits")
        sign = -torch.sign(lower + upper).detach()
        prob = (torch.sigmoid(sign * upper)
                - torch.sigmoid(sign * lower)).abs()
        return lower_bound(prob, 1e-9)

    def bits(self, x, training: bool = True):
        from .gaussian import probs_to_bits

        if training:
            probs = self.prob(x)
        else:
            probs = self(x + 0.5) - self(x - 0.5)
        return probs_to_bits(probs)


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``BitEstimator`` tree (with or without the top ``params``)
    -> this module's state dict: ``Bitparm_0/h`` -> ``Bitparm_0.h``, the
    layout unchanged."""
    if set(params) == {"params"}:
        params = params["params"]
    return {f"{mod}.{leaf}": torch.from_numpy(np.array(value, np.float32))
            for mod, leaves in params.items()
            for leaf, value in leaves.items()}


class FactorizedCoder:
    """Host bridge: the quantized CDF table of a trained ``BitEstimator``
    (one row per channel) registered with an EntropyCoder."""

    def __init__(self, module: BitEstimator):
        self.module = module
        self.entropy_coder = None
        self.cdf_group_index = None
        self._quantized_cdf = None
        self._cdf_length = None
        self._offset = None

    @torch.no_grad()
    def _cdf_at(self, v: np.ndarray) -> np.ndarray:
        """The CDF at host values ``v`` (L, C), evaluated on the module's
        device: (L, C) f32."""
        c = self.module.channels
        device = next(self.module.parameters()).device
        x = torch.as_tensor(np.asarray(v, np.float32)).reshape(1, -1, 1, c)
        return self.module(x.to(device))[0, :, 0, :].cpu().numpy()

    def update(self, entropy_coder: EntropyCoder, force: bool = False):
        """The table as the JAX coder builds it (``factorized.py:87-115``):
        per channel the support [-minimum, maximum], each the least i in
        [2, 50] with CDF(-i) < 1e-4 and CDF(i) > 0.9999; the pmf of the
        integers in it, a tail bucket of the mass outside, quantized."""
        self.entropy_coder = entropy_coder
        if not force and self._offset is not None:
            return
        c = self.module.channels
        minima = np.full(c, 50, np.int64)
        maxima = np.full(c, 50, np.int64)
        for i in range(50, 1, -1):
            probs = self._cdf_at(np.full((1, c), -float(i), np.float32))[0]
            minima = np.where(probs < 1e-4, i, minima)
        for i in range(50, 1, -1):
            probs = self._cdf_at(np.full((1, c), float(i), np.float32))[0]
            maxima = np.where(probs > 0.9999, i, maxima)
        pmf_length = maxima + minima + 1
        max_length = int(pmf_length.max())

        samples = (np.arange(max_length, dtype=np.float32)[:, None]
                   - minima[None, :].astype(np.float32))
        lower = self._cdf_at(samples - 0.5)
        upper = self._cdf_at(samples + 0.5)
        pmf = (upper - lower).T  # (C, L)
        tail_mass = lower[0, :] + (1.0 - upper[-1, :])

        quantized = np.zeros((c, max_length + 2), dtype=np.int32)
        for i in range(c):
            row = np.concatenate([pmf[i, :pmf_length[i]], [tail_mass[i]]])
            cdf = pmf_to_quantized_cdf(row.astype(np.float32))
            quantized[i, :len(cdf)] = cdf
        self._quantized_cdf = quantized
        self._cdf_length = (pmf_length + 2).astype(np.int32)
        self._offset = (-minima).astype(np.int32)
        self.cdf_group_index = entropy_coder.add_cdf(
            self._quantized_cdf, self._cdf_length, self._offset)

    def get_cdf_info(self):
        return self._quantized_cdf, self._cdf_length, self._offset

    def build_indexes(self, shape_nhwc) -> np.ndarray:
        """The CDF row of every element: its channel."""
        n, h, w, c = shape_nhwc
        return np.broadcast_to(
            np.arange(c, dtype=np.int32)[None, None, None, :], (n, h, w, c))

    def encode(self, x: np.ndarray):
        """Integer-valued NHWC ``x``, one channel per CDF row."""
        x = np.asarray(x)
        self.entropy_coder.encode_with_indexes(
            x.reshape(-1), self.build_indexes(x.shape).reshape(-1),
            self.cdf_group_index)

    def decode_stream(self, spatial_hw) -> np.ndarray:
        """(1, H, W, C) f32 decoded from the coder's stream."""
        shape = (1, spatial_hw[0], spatial_hw[1], self.module.channels)
        val = self.entropy_coder.decode_stream(
            self.build_indexes(shape).reshape(-1), self.cdf_group_index)
        return val.reshape(shape).astype(np.float32)
