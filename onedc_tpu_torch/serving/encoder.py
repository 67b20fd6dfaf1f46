"""The host half of encode: rANS-code a write plan and frame the container.

JAX counterpart: ``onedc_tpu/serving/encoder.py:35-78`` (``write_container``,
the one host-side encode bridge, shared there by the live runtime and the
bundle encoder). The bundle encoder (``ServingEncoder``) waits for the
port's serving bundles.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..entropy.framing import encode_i, filesize, write_to_file


def write_container(entropy_coder, gaussian_coder, fsq, out: Dict,
                    pic_width: int, pic_height: int, fp=None,
                    caption: str = "") -> Tuple[bytes, Dict[str, float]]:
    """Code the 4 steps of a one-image write plan (``out["y_q_w"]`` and
    ``out["indexes_w"]``, host arrays) in order, pack ``out["z_indices"]``
    and frame the container; write it to ``fp`` if given. Returns
    (container bytes, bpp dict with the JAX keys)."""
    entropy_coder.reset()
    for step in range(4):
        gaussian_coder.encode_with_indexes(np.asarray(out["y_q_w"][step]),
                                           np.asarray(out["indexes_w"][step]))
    entropy_coder.flush()
    return frame_container(entropy_coder.get_encoded_stream(),
                           fsq.pack_indices(np.asarray(out["z_indices"])),
                           pic_width, pic_height, fp, caption)


def frame_container(bit_stream_y: bytes, bit_stream_z: bytes,
                    pic_width: int, pic_height: int, fp=None,
                    caption: str = "") -> Tuple[bytes, Dict[str, float]]:
    """Frame the y and z streams and the caption; (bytes, bpp dict)."""
    caption_bytes = caption.encode("utf-8") if caption else b""
    total = encode_i(pic_height=pic_height, pic_width=pic_width,
                     bit_stream_y=bit_stream_y, bit_stream_z=bit_stream_z,
                     bit_stream_caption=caption_bytes,
                     caption_length=len(caption_bytes))
    if fp:
        write_to_file(total, fp)
        file_size = filesize(fp)
    else:
        file_size = 0.0
    pixel_num = pic_height * pic_width
    bits_y = len(bit_stream_y) * 8
    bits_z = len(bit_stream_z) * 8
    bits_caption = len(caption_bytes) * 8
    bits_total = len(total) * 8
    return total, {
        "bits_y": bits_y,
        "bits_z": bits_z,
        "bits_caption": bits_caption,
        "bits_total": bits_total,
        "bpp_y": bits_y / pixel_num,
        "bpp_z": bits_z / pixel_num,
        "bpp_caption": bits_caption / pixel_num,
        "bpp": bits_total / pixel_num,
        "bpp_file": file_size * 8 / pixel_num,
    }
