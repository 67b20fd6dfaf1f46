"""Finite Scalar Quantization (FSQ): index <-> code maps and bit packing.

JAX counterpart: ``onedc_tpu/nn/fsq.py``. Levels [4]*7 give a 16384-entry
codebook, i.e. 14-bit indices, least-significant digit first. Quantization
(``bound``, ``quantize``, ``codes_to_indices``, ``__call__``, :37-75) runs
in f32 whatever the input dtype, with a straight-through rounding; codes
are over the LAST dimension ((B, H, W, dim), the JAX layout).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


class FSQ:
    def __init__(self, levels: Sequence[int]):
        self.levels = tuple(int(v) for v in levels)
        self._levels = np.asarray(self.levels, dtype=np.int64)
        self._basis = np.concatenate(
            [[1], np.cumprod(self._levels[:-1])]).astype(np.int64)
        self.codebook_size = int(np.prod(self._levels))
        self.dim = len(self.levels)
        self.index_bits = int(round(np.log2(self.codebook_size)))

    def _consts(self, device):
        levels = torch.as_tensor(self._levels, dtype=torch.float32,
                                 device=device)
        half_width = torch.as_tensor(self._levels // 2, dtype=torch.float32,
                                     device=device)
        return levels, half_width

    def bound(self, z: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
        """z -> tanh(z + shift) * half_l - offset."""
        levels, _ = self._consts(z.device)
        half_l = (levels - 1) * (1 + eps) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """z (..., dim) -> codes in [-1, 1], rounded with a
        straight-through gradient, computed in f32."""
        bounded = self.bound(z.float())
        quantized = bounded + (torch.round(bounded) - bounded).detach()
        return (quantized / self._consts(z.device)[1]).to(z.dtype)

    def codes_to_indices(self, codes: torch.Tensor) -> torch.Tensor:
        _, half_width = self._consts(codes.device)
        digits = codes.float() * half_width + half_width
        basis = torch.as_tensor(self._basis, dtype=torch.float32,
                                device=codes.device)
        return (digits * basis).sum(-1).to(torch.int32)

    def __call__(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z (B, H, W, dim) -> (codes of the same shape, indices (B, H, W)
        taken from the detached codes)."""
        codes = self.quantize(z)
        return codes, self.codes_to_indices(codes.detach())

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """(...) int -> (..., dim) f32 codes in [-1, 1]."""
        dev = indices.device
        basis = torch.as_tensor(self._basis, device=dev)
        levels = torch.as_tensor(self._levels, device=dev)
        digits = torch.div(indices.long()[..., None], basis,
                           rounding_mode="floor") % levels
        half_width = torch.as_tensor(self._levels // 2, dtype=torch.float32,
                                     device=dev)
        return (digits.float() - half_width) / half_width

    def pack_indices(self, indices: np.ndarray) -> bytes:
        """Big-endian bit-contiguous bytes; alignment padding lands in the
        high-order bits (the reference's Python bigint packing)."""
        flat = np.asarray(indices).reshape(-1)
        nbits = self.index_bits
        num_bytes = (len(flat) * nbits + 7) // 8
        value = 0
        for v in flat.tolist():
            value = (value << nbits) | int(v)
        return value.to_bytes(num_bytes, "big")

    def unpack_indices(self, data: bytes, count: int) -> np.ndarray:
        nbits = self.index_bits
        value = int.from_bytes(data, "big")
        out = np.empty(count, dtype=np.int32)
        mask = (1 << nbits) - 1
        for i in range(count - 1, -1, -1):
            out[i] = value & mask
            value >>= nbits
        return out
