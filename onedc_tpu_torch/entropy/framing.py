"""Bitstream container framing, byte-compatible with the reference.

JAX counterpart: ``onedc_tpu/entropy/framing.py``. Container layout:
big-endian ``>2I`` (height, width) + ``>1I`` len(y-stream) + ``>1I``
caption length, then the raw y bytes, z bytes and caption bytes. The
z-stream length is not stored: decode derives it from the padded image
size as ``ceil((padH/ds) * (padW/ds) * index_bits / 8)``.
"""

from __future__ import annotations

import math
import struct


class CorruptBitstreamError(ValueError):
    pass


def get_padding_size(height: int, width: int, p: int = 64):
    """Right/bottom padding that brings (height, width) to multiples of p.
    Returns (left, right, top, bottom)."""
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return 0, new_w - width, 0, new_h - height


def encode_i(pic_height: int, pic_width: int, bit_stream_y: bytes,
             bit_stream_z: bytes, bit_stream_caption=b"",
             caption_length: int = 0) -> bytes:
    """Pack one coded image into the container format."""
    if isinstance(bit_stream_caption, str):
        bit_stream_caption = bit_stream_caption.encode("utf-8")
    header = struct.pack(">4I", pic_height, pic_width, len(bit_stream_y),
                         caption_length)
    return header + bytes(bit_stream_y) + bytes(bit_stream_z) + \
        bytes(bit_stream_caption)


def decode_i(data: bytes, index_unit_length: int, ds: int) -> dict:
    """Unpack the container; the z length follows from the padded size."""
    if len(data) < 16:
        raise CorruptBitstreamError(
            f"container header truncated ({len(data)} bytes)")
    height, width, stream_length, caption_length = struct.unpack(
        ">4I", data[:16])
    if not (0 < height <= 1 << 16 and 0 < width <= 1 << 16):
        raise CorruptBitstreamError(f"implausible image size {height}x{width}")

    pad = get_padding_size(height, width, p=ds)
    pad_h = height + pad[2] + pad[3]
    pad_w = width + pad[0] + pad[1]
    z_len = math.ceil((pad_h // ds) * (pad_w // ds) * index_unit_length / 8.0)

    expected = 16 + stream_length + z_len + caption_length
    if len(data) < expected:
        raise CorruptBitstreamError(
            f"container truncated: {len(data)} bytes < {expected} expected "
            f"for a {height}x{width} image")
    y0 = 16
    z0 = y0 + stream_length
    c0 = z0 + z_len
    return {
        "height": height,
        "width": width,
        "pad_height": pad_h,
        "pad_width": pad_w,
        "pad_tuple": pad,
        "bit_stream_y": bytes(data[y0:z0]),
        "bit_stream_z": bytes(data[z0:c0]),
        "bit_stream_caption": bytes(data[c0:c0 + caption_length]),
    }
