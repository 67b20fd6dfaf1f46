"""The reference's bitstream side: the container, the FSQ index packing, the
Gaussian scale-to-index rule, the rANS coder that writes a y stream from a
write plan and decodes it again, independent of the program.

The container (the published ``encode_i`` / ``decode_i``): a big-endian
header of four uint32 (height, width, y stream length, caption length),
the y stream, the z indices packed at 14 bits each, big-endian and bit
contiguous, then the caption. The rANS decoder is ``rans.cpp`` beside this
file, a frozen copy of the coder, built with ``g++`` into
``build/benchmark/`` at the checkout's root; the CDF bank and the f32
index boundaries are frozen copies too (``data/``).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import struct
import subprocess
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "benchmark"
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")
DS = 64  # padding granularity and the z grid's cell
_lib = None


def padding(height: int, width: int, p: int = DS):
    """(left, right, top, bottom) padding to multiples of p."""
    return (0, -(-width // p) * p - width, 0, -(-height // p) * p - height)


def frame(height: int, width: int, y_stream: bytes, z_bytes: bytes) -> bytes:
    return struct.pack(">4I", height, width, len(y_stream), 0) \
        + y_stream + z_bytes


def parse(data: bytes, index_bits: int = 14) -> dict:
    height, width, ylen, clen = struct.unpack(">4I", data[:16])
    pad = padding(height, width)
    ph, pw = height + pad[3], width + pad[1]
    zlen = math.ceil((ph // DS) * (pw // DS) * index_bits / 8)
    if len(data) < 16 + ylen + zlen + clen:
        raise ValueError(f"container of {len(data)} bytes is truncated")
    return {"height": height, "width": width, "pad_height": ph,
            "pad_width": pw, "y": bytes(data[16:16 + ylen]),
            "z": bytes(data[16 + ylen:16 + ylen + zlen])}


def pack_indices(indices: np.ndarray, bits: int = 14) -> bytes:
    """Big-endian, bit-contiguous; the alignment padding in the high bits."""
    value = 0
    flat = np.asarray(indices).reshape(-1)
    for v in flat.tolist():
        value = (value << bits) | int(v)
    return value.to_bytes((len(flat) * bits + 7) // 8, "big")


def unpack_indices(data: bytes, count: int, bits: int = 14) -> np.ndarray:
    value = int.from_bytes(data, "big")
    mask = (1 << bits) - 1
    out = np.empty(count, dtype=np.int64)
    for i in range(count - 1, -1, -1):
        out[i] = value & mask
        value >>= bits
    return out


def z_indices(dec: dict) -> np.ndarray:
    zh, zw = dec["pad_height"] // DS, dec["pad_width"] // DS
    return unpack_indices(dec["z"], zh * zw).reshape(1, zh, zw)


def scale_indexes(scales: torch.Tensor) -> torch.Tensor:
    """float32 scales -> CDF index: the number of the 255 frozen f32
    boundaries at or below the scale (0..255)."""
    bounds = torch.from_numpy(np.load(HERE / "data" / "scale_bounds.npz")
                              ["bounds"]).to(scales.device)
    return torch.bucketize(scales.float().contiguous(), bounds, right=True)


def _library():
    global _lib
    if _lib is None:
        src = HERE / "rans.cpp"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(GXX_FLAGS).encode()).hexdigest()
        path = BUILD_DIR / f"rans-{digest[:16]}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.so")
            subprocess.run([os.environ.get("CXX", "g++"), *GXX_FLAGS, "-o",
                            str(tmp), str(src)], check=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        vp, i32p, i16p = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
                          ctypes.POINTER(ctypes.c_int16))
        sigs = {"onedc_decoder_new": (vp, [ctypes.c_int]),
                "onedc_decoder_free": (None, [vp]),
                "onedc_decoder_add_cdf": (ctypes.c_int, [
                    vp, i32p, ctypes.c_int, ctypes.c_int, i32p, i32p]),
                "onedc_decoder_set_stream": (None, [
                    vp, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]),
                "onedc_decoder_decode": (None, [
                    vp, i16p, ctypes.c_int, ctypes.c_int, i16p]),
                "onedc_encoder_new": (vp, [ctypes.c_int]),
                "onedc_encoder_free": (None, [vp]),
                "onedc_encoder_add_cdf": (ctypes.c_int, [
                    vp, i32p, ctypes.c_int, ctypes.c_int, i32p, i32p]),
                "onedc_encoder_encode": (None, [
                    vp, i16p, i16p, ctypes.c_int, ctypes.c_int]),
                "onedc_encoder_flush": (None, [vp]),
                "onedc_encoder_stream_size": (ctypes.c_int, [vp]),
                "onedc_encoder_get_stream": (None, [
                    vp, ctypes.POINTER(ctypes.c_uint8)])}
        for name, (res, args) in sigs.items():
            getattr(lib, name).restype = res
            getattr(lib, name).argtypes = args
        _lib = lib
    return _lib


def _bank():
    bank = np.load(HERE / "data" / "gaussian_cdf16.npz")
    return [np.ascontiguousarray(bank[k], dtype=np.int32)
            for k in ("quantized_cdf", "cdf_length", "offset")]


def encode_y(steps) -> bytes:
    """The y stream of a write plan: each step's (symbols, indexes), in
    step order, coded into one rANS stream."""
    lib = _library()
    cdf, length, offset = _bank()
    h = lib.onedc_encoder_new(1)
    try:
        group = lib.onedc_encoder_add_cdf(
            h, _ptr(cdf, ctypes.c_int32), cdf.shape[0], cdf.shape[1],
            _ptr(length, ctypes.c_int32), _ptr(offset, ctypes.c_int32))
        for symbols, indexes in steps:
            sym = np.ascontiguousarray(np.clip(np.asarray(symbols).reshape(
                -1), -30000, 30000), dtype=np.int16)
            idx = np.ascontiguousarray(np.asarray(indexes).reshape(-1),
                                       dtype=np.int16)
            lib.onedc_encoder_encode(h, _ptr(sym, ctypes.c_int16),
                                     _ptr(idx, ctypes.c_int16), sym.shape[0],
                                     group)
        lib.onedc_encoder_flush(h)
        out = np.empty(lib.onedc_encoder_stream_size(h), dtype=np.uint8)
        if out.size:
            lib.onedc_encoder_get_stream(h, _ptr(out, ctypes.c_uint8))
        return out.tobytes()
    finally:
        lib.onedc_encoder_free(h)


class YDecoder:
    """One y stream, decoded step by step under given CDF indexes."""

    def __init__(self, stream: bytes):
        lib = _library()
        self._keep = _bank()
        self._data = np.frombuffer(stream, dtype=np.uint8).copy()
        cdf, length, offset = self._keep
        self._h = lib.onedc_decoder_new(1)
        self._group = lib.onedc_decoder_add_cdf(
            self._h, _ptr(cdf, ctypes.c_int32), cdf.shape[0], cdf.shape[1],
            _ptr(length, ctypes.c_int32), _ptr(offset, ctypes.c_int32))
        lib.onedc_decoder_set_stream(self._h, _ptr(self._data, ctypes.c_uint8),
                                     self._data.shape[0])

    def decode(self, indexes: np.ndarray) -> np.ndarray:
        """int16 symbols in the shape of ``indexes`` (decoded in its C
        order)."""
        idx = np.ascontiguousarray(indexes, dtype=np.int16).reshape(-1)
        out = np.empty_like(idx)
        _library().onedc_decoder_decode(self._h, _ptr(idx, ctypes.c_int16),
                                        idx.shape[0], self._group,
                                        _ptr(out, ctypes.c_int16))
        return out.reshape(indexes.shape)

    def __del__(self):
        if getattr(self, "_h", None):
            _library().onedc_decoder_free(self._h)
            self._h = None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))
