"""Finite Scalar Quantization (FSQ): index <-> code maps and bit packing.

JAX counterpart: ``onedc_tpu/nn/fsq.py``. Levels [4]*7 give a 16384-entry
codebook, i.e. 14-bit indices, least-significant digit first. The decode
slice needs ``indices_to_codes`` and the host packing only.
"""

from __future__ import annotations

from typing import Sequence

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
