"""Host-side rANS coder: ctypes bindings to the native library.

JAX counterpart: ``onedc_tpu/ops/rans.py`` (native half only). The C++
source is this package's own copy, ``ops/cpp/onedc_rans.cpp``, built with
``g++`` at first use into ``build/onedc_tpu_torch/`` (see ``ops/build.py``).
There is no pure-Python coder here: if the library does not build, the
build raises.

API mirrors the reference's ``MLCodec_rans`` module:

    RansEncoder(stream_part).{add_cdf, encode_with_indexes, flush,
        get_encoded_stream, reset}
    RansDecoder(stream_part).{add_cdf, set_stream, decode_stream}
    decode_streams_multi(decoders, indexes, group)
    pmf_to_quantized_cdf(pmf, precision)  (the reference's MLCodec_CXX)

``pmf_to_quantized_cdf_np`` is the quantizer in numpy (JAX
``ops/rans.py:121-152``), the plain version the tests hold the native one
against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .build import load_library

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I16P = ctypes.POINTER(ctypes.c_int16)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_VP = ctypes.c_void_p

_SIGNATURES = {
    "onedc_encoder_new": (_VP, [ctypes.c_int]),
    "onedc_encoder_free": (None, [_VP]),
    "onedc_encoder_add_cdf": (ctypes.c_int, [
        _VP, _I32P, ctypes.c_int, ctypes.c_int, _I32P, _I32P]),
    "onedc_encoder_encode": (None, [
        _VP, _I16P, _I16P, ctypes.c_int, ctypes.c_int]),
    "onedc_encoder_flush": (None, [_VP]),
    "onedc_encoder_stream_size": (ctypes.c_int, [_VP]),
    "onedc_encoder_get_stream": (None, [_VP, _U8P]),
    "onedc_encoder_reset": (None, [_VP]),
    "onedc_decoder_new": (_VP, [ctypes.c_int]),
    "onedc_decoder_free": (None, [_VP]),
    "onedc_decoder_add_cdf": (ctypes.c_int, [
        _VP, _I32P, ctypes.c_int, ctypes.c_int, _I32P, _I32P]),
    "onedc_decoder_set_stream": (None, [_VP, _U8P, ctypes.c_int]),
    "onedc_decoder_decode": (None, [
        _VP, _I16P, ctypes.c_int, ctypes.c_int, _I16P]),
    "onedc_decoder_decode_multi": (None, [
        ctypes.POINTER(_VP), ctypes.c_int, _I16P, ctypes.c_int,
        ctypes.c_int, _I16P]),
    "onedc_pmf_to_quantized_cdf": (None, [_F32P, ctypes.c_int, ctypes.c_int,
                                          _U32P]),
}

PRECISION = 16


def native_lib() -> ctypes.CDLL:
    """The rANS library, built on first use."""
    return load_library("onedc_rans", _SIGNATURES)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pmf_to_quantized_cdf(pmf, precision: int = PRECISION) -> np.ndarray:
    """uint32 [n + 1] quantized CDF of the n-bucket ``pmf`` (total
    ``2**precision``, every bucket at least 1 wide where another bucket can
    give), by the native library."""
    pmf = np.ascontiguousarray(pmf, dtype=np.float32).reshape(-1)
    out = np.empty(pmf.shape[0] + 1, dtype=np.uint32)
    native_lib().onedc_pmf_to_quantized_cdf(
        _ptr(pmf, ctypes.c_float), pmf.shape[0], precision,
        _ptr(out, ctypes.c_uint32))
    return out


def pmf_to_quantized_cdf_np(pmf, precision: int = PRECISION) -> np.ndarray:
    """The quantizer in numpy, the reference's ``ops.cpp:24-82``: f32
    rounding of p * 2^precision plus 0.5, truncated; integer
    renormalisation to a total of 2^precision; then each zero-width bucket
    takes one from the narrowest bucket wider than 1."""
    pmf = np.asarray(pmf, dtype=np.float32).reshape(-1)
    n = pmf.shape[0]
    cdf = np.zeros(n + 1, dtype=np.uint64)
    cdf[1:] = (np.round(pmf * np.float32(1 << precision)).astype(np.float64)
               + 0.5).astype(np.uint64)
    total = int(cdf.sum()) or 1
    cdf = ((1 << precision) * cdf) // total
    cdf = np.cumsum(cdf, dtype=np.uint64)
    cdf[-1] = 1 << precision
    cdf = cdf.astype(np.int64)
    for i in range(n):
        if cdf[i] != cdf[i + 1]:
            continue
        freqs = cdf[1:] - cdf[:-1]
        candidates = np.where(freqs > 1)[0]
        if candidates.size == 0:
            continue
        steal = candidates[np.argmin(freqs[candidates])]
        if steal < i:
            cdf[steal + 1:i + 1] -= 1
        else:
            cdf[i + 1:steal + 1] += 1
    return cdf.astype(np.uint32)


def _cdf_args(cdfs, cdfs_sizes, offsets):
    cdfs = np.ascontiguousarray(cdfs, dtype=np.int32)
    sizes = np.ascontiguousarray(cdfs_sizes, dtype=np.int32).reshape(-1)
    offs = np.ascontiguousarray(offsets, dtype=np.int32).reshape(-1)
    if cdfs.ndim != 2 or sizes.shape[0] != cdfs.shape[0] \
            or offs.shape[0] != cdfs.shape[0]:
        raise ValueError(f"bad CDF table shapes {cdfs.shape}, {sizes.shape}, "
                         f"{offs.shape}")
    if sizes.max() > cdfs.shape[1]:
        raise ValueError("a CDF length exceeds the table width")
    return cdfs, sizes, offs


def _as_i16(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int16).reshape(-1)


class RansEncoder:
    def __init__(self, stream_part: int = 1):
        self._lib = native_lib()
        self._h = self._lib.onedc_encoder_new(max(1, stream_part))
        self._n_groups = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.onedc_encoder_free(self._h)
            self._h = None

    def add_cdf(self, cdfs, cdfs_sizes, offsets) -> int:
        cdfs, sizes, offs = _cdf_args(cdfs, cdfs_sizes, offsets)
        self._n_groups += 1
        return self._lib.onedc_encoder_add_cdf(
            self._h, _ptr(cdfs, ctypes.c_int32), cdfs.shape[0], cdfs.shape[1],
            _ptr(sizes, ctypes.c_int32), _ptr(offs, ctypes.c_int32))

    def encode_with_indexes(self, symbols, indexes, cdf_group_index: int):
        symbols = _as_i16(symbols)
        indexes = _as_i16(indexes)
        if symbols.shape != indexes.shape:
            raise ValueError(f"{symbols.shape[0]} symbols, "
                             f"{indexes.shape[0]} indexes")
        if not 0 <= cdf_group_index < self._n_groups:
            raise ValueError(f"no CDF group {cdf_group_index}")
        self._lib.onedc_encoder_encode(
            self._h, _ptr(symbols, ctypes.c_int16),
            _ptr(indexes, ctypes.c_int16), symbols.shape[0], cdf_group_index)

    def flush(self):
        self._lib.onedc_encoder_flush(self._h)

    def get_encoded_stream(self) -> np.ndarray:
        n = self._lib.onedc_encoder_stream_size(self._h)
        out = np.empty(n, dtype=np.uint8)
        if n:
            self._lib.onedc_encoder_get_stream(self._h,
                                               _ptr(out, ctypes.c_uint8))
        return out

    def reset(self):
        self._lib.onedc_encoder_reset(self._h)


class RansDecoder:
    def __init__(self, stream_part: int = 1):
        self._lib = native_lib()
        self._h = self._lib.onedc_decoder_new(max(1, stream_part))
        self._n_groups = 0
        self._stream = None  # the library reads the bytes in place

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.onedc_decoder_free(self._h)
            self._h = None

    def add_cdf(self, cdfs, cdfs_sizes, offsets) -> int:
        cdfs, sizes, offs = _cdf_args(cdfs, cdfs_sizes, offsets)
        self._n_groups += 1
        return self._lib.onedc_decoder_add_cdf(
            self._h, _ptr(cdfs, ctypes.c_int32), cdfs.shape[0], cdfs.shape[1],
            _ptr(sizes, ctypes.c_int32), _ptr(offs, ctypes.c_int32))

    def set_stream(self, encoded):
        data = np.ascontiguousarray(np.asarray(encoded, dtype=np.uint8))
        self._stream = data
        self._lib.onedc_decoder_set_stream(
            self._h, _ptr(data, ctypes.c_uint8), data.shape[0])

    def _check_group(self, cdf_group_index: int):
        if not 0 <= cdf_group_index < self._n_groups:
            raise ValueError(f"no CDF group {cdf_group_index}")

    def decode_stream(self, indexes, cdf_group_index: int) -> np.ndarray:
        self._check_group(cdf_group_index)
        indexes = _as_i16(indexes)
        out = np.empty(indexes.shape[0], dtype=np.int16)
        self._lib.onedc_decoder_decode(
            self._h, _ptr(indexes, ctypes.c_int16), indexes.shape[0],
            cdf_group_index, _ptr(out, ctypes.c_int16))
        return out


def decode_streams_multi(decoders, indexes, cdf_group_index: int):
    """Decode one same-length index row per decoder in ONE native call.
    ``indexes``: (n_dec, n) int16. Returns (n_dec, n) int16, identical to
    ``decode_stream`` on each decoder."""
    indexes = np.ascontiguousarray(indexes, dtype=np.int16)
    if indexes.ndim != 2 or indexes.shape[0] != len(decoders):
        raise ValueError(f"indexes {indexes.shape} for {len(decoders)} "
                         f"decoders")
    for d in decoders:
        d._check_group(cdf_group_index)
    n_dec, n = indexes.shape
    handles = (ctypes.c_void_p * n_dec)(*[d._h for d in decoders])
    out = np.empty((n_dec, n), dtype=np.int16)
    native_lib().onedc_decoder_decode_multi(
        handles, n_dec, _ptr(indexes, ctypes.c_int16), n, cdf_group_index,
        _ptr(out, ctypes.c_int16))
    return out
