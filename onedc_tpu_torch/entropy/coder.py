"""Host-side entropy coder facade (one encoder + one decoder pair).

JAX counterpart: ``onedc_tpu/entropy/coder.py``. int16 symbols clamped to
+/-30000; the CDF registry index is the same on both sides.
"""

from __future__ import annotations

import numpy as np

from ..ops.rans import RansDecoder, RansEncoder, decode_streams_multi


class EntropyCoder:
    def __init__(self, stream_part: int = 1):
        self.encoder = RansEncoder(stream_part)
        self.decoder = RansDecoder(stream_part)

    def add_cdf(self, cdf, cdf_length, offset) -> int:
        enc_idx = self.encoder.add_cdf(cdf, cdf_length, offset)
        dec_idx = self.decoder.add_cdf(cdf, cdf_length, offset)
        if enc_idx != dec_idx:
            raise RuntimeError(f"CDF group {enc_idx} != {dec_idx}")
        return enc_idx

    def reset(self):
        self.encoder.reset()

    def encode_with_indexes(self, symbols, indexes, cdf_group_index: int):
        symbols = np.clip(np.asarray(symbols).reshape(-1), -30000, 30000)
        self.encoder.encode_with_indexes(
            symbols.astype(np.int16),
            np.asarray(indexes).reshape(-1).astype(np.int16), cdf_group_index)

    def flush(self):
        self.encoder.flush()

    def get_encoded_stream(self) -> bytes:
        return self.encoder.get_encoded_stream().tobytes()

    def set_stream(self, stream: bytes):
        self.decoder.set_stream(np.frombuffer(stream, dtype=np.uint8))

    def decode_stream(self, indexes, cdf_group_index: int) -> np.ndarray:
        return self.decoder.decode_stream(
            np.asarray(indexes).reshape(-1).astype(np.int16), cdf_group_index)

    @staticmethod
    def decode_streams(coders, indexes, cdf_group_index: int) -> np.ndarray:
        """One native call over several coders' streams; ``indexes`` is
        (n_coders, n). Same output as ``decode_stream`` per coder."""
        idx = np.asarray(indexes).reshape(len(coders), -1).astype(np.int16)
        return decode_streams_multi([c.decoder for c in coders], idx,
                                    cdf_group_index)
