"""Conditional Gaussian entropy model: bit estimates for training, scale ->
CDF index, and the coder bridge.

JAX counterpart: ``onedc_tpu/entropy/gaussian.py`` (``gaussian_prob``,
``probs_to_bits``, ``gaussian_bits`` :58-99, ``build_indexes`` :101-116
and the host half :135-284). The CDF bank is this package's own
copy of the vendored table, ``entropy/data/gaussian_cdf16.npz``, captured
from the reference's ``GaussianEncoder.update``; bitstream interop needs
it bit-identical, so it is loaded, never recomputed.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from .bound import lower_bound
from .coder import EntropyCoder

SCALE_MIN = 0.11
SCALE_MAX = 64.0
SCALE_LEVELS = 256
LOG_SCALE_MIN = math.log(SCALE_MIN)
LOG_SCALE_STEP = (math.log(SCALE_MAX) - LOG_SCALE_MIN) / (SCALE_LEVELS - 1)

_CDF_BANK = Path(__file__).resolve().parent / "data" / "gaussian_cdf16.npz"


def scale_table() -> np.ndarray:
    """The 256 log-spaced scales (np.linspace endpoints, as the JAX
    package and the reference's torch.linspace)."""
    return np.exp(np.linspace(LOG_SCALE_MIN, math.log(SCALE_MAX),
                              SCALE_LEVELS)).astype(np.float32)


_SCALE_BOUNDS = Path(__file__).resolve().parent / "data" / "scale_bounds.npz"
_bounds_by_device: dict = {}


def scale_bounds(device=None) -> torch.Tensor:
    """f32 [255]: bounds[k - 1] is the least f32 scale whose index is k.

    The JAX package computes the index as ``int((log(s) - LOG_SCALE_MIN) /
    LOG_SCALE_STEP)`` in f32, which XLA compiles to ``(log(s) + c0) * c1``;
    the table is that step function as the JAX package computes it on the
    CPU (``tests/test_torch_entropy.py`` derives it again from
    ``onedc_tpu.entropy.gaussian.build_indexes`` and compares). Indexing by
    comparison with it makes the index independent of any ``log``
    implementation: every device gives the same integer for the same f32
    scale, and a boundary scale indexes as in the JAX package.
    """
    device = torch.device("cpu" if device is None else device)
    if device not in _bounds_by_device:
        _bounds_by_device[device] = torch.from_numpy(
            np.load(_SCALE_BOUNDS)["bounds"]).to(device)
    return _bounds_by_device[device]


def build_indexes(scales: torch.Tensor, skip_thres=None) -> torch.Tensor:
    """sigma -> scale-table index (int32); sigma < skip_thres -> -1.

    Always f32, whatever the pipeline dtype: the integer index must not
    depend on it. The index is the number of ``scale_bounds`` at or below
    the scale. Runs on the scales' device, so the four-part decode ships
    integer indexes, not f32 scales, to the host.
    """
    scales = scales.float().contiguous()
    idx = torch.bucketize(scales, scale_bounds(scales.device), out_int32=True,
                          right=True)
    if skip_thres is not None:
        idx = torch.where(scales < skip_thres, -1, idx)
    return idx


def gaussian_prob(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """P(round(v) | N(0, scale)) by the complementary error function, the
    training-time estimator (``onedc_tpu/entropy/gaussian.py:58-69``),
    including its |v| symmetry trick."""
    const = -(2 ** -0.5)
    scales = lower_bound(scales, 0.11)
    values = values.abs()
    upper = torch.special.erfc(const * ((0.5 - values) / scales))
    lower = torch.special.erfc(const * ((-0.5 - values) / scales))
    return lower_bound(0.5 * (upper - lower), 1e-9)


def probs_to_bits(probs: torch.Tensor) -> torch.Tensor:
    """-log2(p + 1e-5), bounded below by 0 (``gaussian.py:83-85``)."""
    bits = -torch.log(probs + 1e-5) / math.log(2.0)
    return lower_bound(bits, 0.0)


def gaussian_bits(y: torch.Tensor, sigma: torch.Tensor,
                  training: bool = True) -> torch.Tensor:
    """Bits to code y under N(0, sigma) (``gaussian.py:88-98``): the erfc
    estimator in training, the exact CDF difference in eval."""
    if training:
        probs = gaussian_prob(y, sigma)
    else:
        sigma = torch.clamp(sigma, 1e-5, 1e10)
        const = 1.0 / (sigma * math.sqrt(2.0))
        upper = 0.5 * (1.0 + torch.special.erf((y + 0.5) * const))
        lower = 0.5 * (1.0 + torch.special.erf((y - 0.5) * const))
        probs = upper - lower
    return probs_to_bits(probs)


def load_cdf_table():
    """(quantized_cdf int32 [256, L], cdf_length int32, offset int32)."""
    d = np.load(_CDF_BANK)
    return (d["quantized_cdf"].astype(np.int32),
            d["cdf_length"].astype(np.int32), d["offset"].astype(np.int32))


class GaussianConditionalCoder:
    """Host bridge: registers the CDF bank with an EntropyCoder and codes
    symbols under device-computed indexes."""

    def __init__(self):
        self.entropy_coder = None
        self.cdf_group_index = None
        self._cdf_info = None

    def update(self, entropy_coder: EntropyCoder, force: bool = False):
        self.entropy_coder = entropy_coder
        if not force and self._cdf_info is not None:
            return
        self._cdf_info = load_cdf_table()
        self.cdf_group_index = entropy_coder.add_cdf(*self._cdf_info)

    def get_cdf_info(self):
        return self._cdf_info

    def set_cdf_info(self, quantized_cdf, cdf_length, offset):
        self._cdf_info = (np.asarray(quantized_cdf, np.int32),
                          np.asarray(cdf_length, np.int32).reshape(-1),
                          np.asarray(offset, np.int32).reshape(-1))

    def encode_with_indexes(self, symbols: np.ndarray, indexes: np.ndarray):
        self.entropy_coder.encode_with_indexes(
            np.asarray(symbols), np.asarray(indexes), self.cdf_group_index)

    def decode_stream_with_indexes(self, indexes: np.ndarray) -> np.ndarray:
        """int16 symbols in the shape of ``indexes``."""
        indexes = np.asarray(indexes)
        vals = self.entropy_coder.decode_stream(indexes, self.cdf_group_index)
        return vals.reshape(indexes.shape)

    @staticmethod
    def decode_streams_with_indexes(coders, indexes: np.ndarray) -> np.ndarray:
        """Batched ``decode_stream_with_indexes``: one batch row of
        ``indexes`` per coder, decoded in ONE native call."""
        indexes = np.asarray(indexes)
        if indexes.shape[0] != len(coders) or not coders:
            raise ValueError(f"{indexes.shape[0]} index rows for "
                             f"{len(coders)} coders")
        gi = coders[0].cdf_group_index
        if any(c.cdf_group_index != gi for c in coders):
            raise ValueError("coders registered different CDF groups")
        vals = EntropyCoder.decode_streams(
            [c.entropy_coder for c in coders], indexes, gi)
        return vals.reshape(indexes.shape)
