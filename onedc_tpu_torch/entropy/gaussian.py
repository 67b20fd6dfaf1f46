"""Conditional Gaussian (and Laplace) entropy model: bit estimates for
training, scale -> CDF index, the CDF banks and the coder bridge.

JAX counterpart: ``onedc_tpu/entropy/gaussian.py`` (``gaussian_prob``,
``laplace_prob``, ``probs_to_bits``, ``gaussian_bits`` :58-99,
``build_indexes`` :101-116, ``build_cdf_table`` :135-188 and the host
half :191-284). Two scale families, as the reference's
``GaussianEncoder(distribution=...)``: "gaussian" (256 log-spaced scales
in [0.11, 64], what OneDC ships) and "laplace" (the same spacing from
0.01). Each family's CDF bank is this package's own copy of the vendored
table, ``entropy/data/{gaussian,laplace}_cdf16.npz``, captured from the
reference's ``GaussianEncoder.update``; bitstream interop needs it
bit-identical, so it is loaded by default, and ``build_cdf_table(...,
allow_vendored=False)`` computes it in numpy (the executable spec).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
from scipy import special as sp_special

from ..ops.rans import pmf_to_quantized_cdf
from .bound import lower_bound
from .coder import EntropyCoder

SCALE_MIN = 0.11
SCALE_MAX = 64.0
SCALE_LEVELS = 256
LOG_SCALE_MIN = math.log(SCALE_MIN)
LOG_SCALE_STEP = (math.log(SCALE_MAX) - LOG_SCALE_MIN) / (SCALE_LEVELS - 1)
# the least scale of each family (the reference's entropy_models.py:256-267)
DIST_SCALE_MIN = {"gaussian": SCALE_MIN, "laplace": 0.01}

_DATA = Path(__file__).resolve().parent / "data"
# f32 index boundaries per family (``scale_bounds``)
_SCALE_BOUNDS = {"gaussian": _DATA / "scale_bounds.npz",
                 "laplace": _DATA / "laplace_scale_bounds.npz"}
_bounds_by_device: dict = {}


def _family(distribution: str) -> str:
    if distribution not in DIST_SCALE_MIN:
        raise ValueError(f"unknown distribution {distribution!r}: "
                         f"{sorted(DIST_SCALE_MIN)}")
    return distribution


def scale_table(dtype=np.float32, distribution: str = "gaussian"
                ) -> np.ndarray:
    """The family's 256 log-spaced scales (np.linspace endpoints, as the
    JAX package and the reference's torch.linspace)."""
    lo = math.log(DIST_SCALE_MIN[_family(distribution)])
    return np.exp(np.linspace(lo, math.log(SCALE_MAX),
                              SCALE_LEVELS)).astype(dtype)


def scale_bounds(device=None, distribution: str = "gaussian"
                 ) -> torch.Tensor:
    """f32 [255]: bounds[k - 1] is the least f32 scale whose index is k.

    The JAX package computes the index as ``int((log(s) - log_min) /
    log_step)`` in f32, which XLA compiles to ``(log(s) + c0) * c1``;
    the table is that step function as the JAX package computes it on the
    CPU, one file per family (``tests/test_torch_entropy.py`` and
    ``tests/test_torch_entropy_toolbox.py`` derive them again from
    ``onedc_tpu.entropy.gaussian.build_indexes`` and compare). Indexing by
    comparison with it makes the index independent of any ``log``
    implementation: every device gives the same integer for the same f32
    scale, and a boundary scale indexes as in the JAX package.
    """
    device = torch.device("cpu" if device is None else device)
    key = (device, _family(distribution))
    if key not in _bounds_by_device:
        _bounds_by_device[key] = torch.from_numpy(
            np.load(_SCALE_BOUNDS[distribution])["bounds"]).to(device)
    return _bounds_by_device[key]


def build_indexes(scales: torch.Tensor, skip_thres=None,
                  distribution: str = "gaussian") -> torch.Tensor:
    """sigma -> scale-table index (int32); sigma < skip_thres -> -1.

    Always f32, whatever the pipeline dtype: the integer index must not
    depend on it. The index is the number of ``scale_bounds`` at or below
    the scale. Runs on the scales' device, so the four-part decode ships
    integer indexes, not f32 scales, to the host.
    """
    scales = scales.float().contiguous()
    idx = torch.bucketize(scales, scale_bounds(scales.device, distribution),
                          out_int32=True, right=True)
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


def laplace_prob(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """P(round(v) | Laplace(0, scale)), scales bounded below by 0.01
    (``onedc_tpu/entropy/gaussian.py:72-80``)."""
    scales = lower_bound(scales, 0.01)

    def cdf2(x):
        return torch.sign(x) * (1.0 - torch.exp(-x.abs()))

    upper = cdf2((values + 0.5) / scales)
    lower = cdf2((values - 0.5) / scales)
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


def _normal_cdf(x: np.ndarray, sigma: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + sp_special.erf(x / (sigma * np.sqrt(2.0))))


def _laplace_cdf(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    # CDF of Laplace(0, scale): 0.5 + 0.5 sign(x) (1 - exp(-|x| / scale))
    return 0.5 + 0.5 * np.sign(x) * (1.0 - np.exp(-np.abs(x) / scale))


_DIST_CDF = {"gaussian": _normal_cdf, "laplace": _laplace_cdf}


def build_cdf_table(precision: int = 16, allow_vendored: bool = True,
                    distribution: str = "gaussian"):
    """The family's quantized CDF bank over its 256 scales: (quantized_cdf
    int32 [256, max_len + 2], cdf_length int32, offset int32).

    At 16 bits the vendored table (``entropy/data/<family>_cdf16.npz``),
    unless ``allow_vendored`` is false; else computed as the reference's
    ``GaussianEncoder.update`` does: per scale the half-width c, the
    least i in [2, 50] with CDF(i) > 0.9999; the pmf over [-c, c] plus a
    tail bucket of 2 CDF(-c - 0.5), in f64, rounded to f32 and quantized by
    ``pmf_to_quantized_cdf``. The reference computes its pmfs with torch
    f32 erf / exp, 1 ulp off f64 on a few percent of the rows, which moves
    a few quantized entries: the vendored table is its own capture.
    """
    _family(distribution)
    if allow_vendored and precision == 16:
        d = np.load(_DATA / f"{distribution}_cdf16.npz")
        return (d["quantized_cdf"].astype(np.int32),
                d["cdf_length"].astype(np.int32),
                d["offset"].astype(np.int32))
    cdf_fn = _DIST_CDF[distribution]
    scales = scale_table(np.float64, distribution)
    centers = np.full(SCALE_LEVELS, 50, dtype=np.int64)
    for i in range(50, 1, -1):
        centers = np.where(cdf_fn(np.float64(i), scales) > 0.9999, i,
                           centers)
    pmf_length = 2 * centers + 1
    max_length = int(pmf_length.max())

    samples = (np.arange(max_length, dtype=np.float64)[None, :]
               - centers[:, None])
    sig = scales[:, None]
    upper = cdf_fn(samples + 0.5, sig)
    lower = cdf_fn(samples - 0.5, sig)
    pmf = (upper - lower).astype(np.float32)
    tail_mass = (2.0 * lower[:, :1]).astype(np.float32)

    quantized = np.zeros((SCALE_LEVELS, max_length + 2), dtype=np.int32)
    for i in range(SCALE_LEVELS):
        row = np.concatenate([pmf[i, :pmf_length[i]], tail_mass[i]])
        cdf = pmf_to_quantized_cdf(row, precision)
        quantized[i, :len(cdf)] = cdf
    return (quantized, (pmf_length + 2).astype(np.int32),
            (-centers).astype(np.int32))


def build_gaussian_cdf_table(precision: int = 16,
                             allow_vendored: bool = True):
    return build_cdf_table(precision, allow_vendored, "gaussian")


def load_cdf_table():
    """The vendored Gaussian bank: (quantized_cdf int32 [256, L],
    cdf_length int32, offset int32)."""
    return build_cdf_table()


class GaussianConditionalCoder:
    """Host bridge: registers the family's CDF bank with an EntropyCoder
    and codes symbols under indexes that the callers compute on the
    device (``build_indexes`` with the coder's ``distribution``), where
    JAX's ``encode`` / ``decode_stream`` also take host scales."""

    def __init__(self, distribution: str = "gaussian"):
        self.distribution = _family(distribution)
        self.entropy_coder = None
        self.cdf_group_index = None
        self._cdf_info = None

    def update(self, entropy_coder: EntropyCoder, force: bool = False):
        self.entropy_coder = entropy_coder
        if not force and self._cdf_info is not None:
            return
        self._cdf_info = build_cdf_table(distribution=self.distribution)
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


def make_stream_coders(master: GaussianConditionalCoder, y_streams):
    """One coder per y bitstream, each on its own EntropyCoder, sharing the
    CDF bank of ``master`` (JAX ``serving/decoder.py:39``)."""
    cdf_info = master.get_cdf_info()
    coders = []
    for ys in y_streams:
        ec = EntropyCoder()
        gc = GaussianConditionalCoder(master.distribution)
        gc.set_cdf_info(*cdf_info)
        gc.entropy_coder = ec
        gc.cdf_group_index = ec.add_cdf(*cdf_info)
        ec.set_stream(ys)
        coders.append(gc)
    return coders
