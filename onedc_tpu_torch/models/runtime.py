"""Host side of the codec: the encode's rANS write and framing, and the
decode's four-part rANS <-> prior-net loop.

JAX counterpart: ``onedc_tpu/models/runtime.py`` (:75-126 encode,
:130-221 decode) and ``onedc_tpu/serving/pipeline.py:58
_narrow_symbols``. The four-part prior forces 4 host <-> device round
trips per decode: the rANS decode of part i needs the CDF indexes that the
prior net computes from parts < i.

Batch invariance: the CDF index is a truncated log-ratio of a bf16 scale,
so a last-ulp difference in the prior nets can flip an index and desync
rANS. cuDNN picks its algorithm by shape, so a batch of B images need not
give an image the bits it gets alone, as the writer computed them. The
prior programs therefore run one image at a time, on the image's own
(1, ...) tensors; the rANS decode of all streams of a bucket is still one
native call per step, and everything after the loop runs batched.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.framing import decode_i, read_from_file
from ..entropy.gaussian import GaussianConditionalCoder
from ..serving.encoder import frame_container, write_container
from .codec import LatentCodec


# the keys of a write plan that the host codes
WRITE_KEYS = ("y_q_w", "indexes_w", "z_indices")


def host_arrays(value):
    """A device tensor, or a tuple of them, -> numpy on the host."""
    if isinstance(value, tuple):
        return tuple(host_arrays(v) for v in value)
    return value.cpu().numpy()


def narrow_symbols(parts: np.ndarray) -> np.ndarray:
    """Ship decoded symbols as int8 when they fit (halves the host ->
    device upload); the update program casts to its dtype either way."""
    if parts.dtype == np.int16 and parts.size \
            and parts.min() >= -128 and parts.max() <= 127:
        return parts.astype(np.int8)
    return parts


class CodecRuntime:
    """Owns the codec module plus the entropy-coder host state."""

    def __init__(self, codec: LatentCodec, device: torch.device):
        self.codec = codec
        self.device = device
        self.entropy_coder = EntropyCoder()
        self.gaussian_coder = GaussianConditionalCoder()
        self.gaussian_coder.update(self.entropy_coder, force=True)
        self.fsq = codec.z_vq
        self.ds = codec.ds

    def encode(self, x, cond, pic_width: int, pic_height: int, fp=None,
               caption: str = "") -> Tuple[bytes, Dict[str, float]]:
        """x (1, 3, H, W) padded to a multiple of 64, cond (1, cond_ch,
        H/8, W/8) -> (container bytes, bpp dict)."""
        out = self.codec.compress(x, cond)
        if self.codec.z_only:
            return self.encode_z_only(out["z_indices"].cpu().numpy(),
                                      pic_width, pic_height, fp, caption)
        return self.write_streams(
            {k: host_arrays(out[k]) for k in WRITE_KEYS}, pic_width,
            pic_height, fp, caption)

    def write_streams(self, out: Dict, pic_width: int, pic_height: int,
                      fp=None, caption: str = ""
                      ) -> Tuple[bytes, Dict[str, float]]:
        """The host half of encode: a one-image write plan of host arrays
        -> (container bytes, bpp dict)."""
        return write_container(self.entropy_coder, self.gaussian_coder,
                               self.fsq, out, pic_width, pic_height, fp=fp,
                               caption=caption)

    def encode_z_only(self, z_indices: np.ndarray, pic_width: int,
                      pic_height: int, fp=None, caption: str = ""
                      ) -> Tuple[bytes, Dict[str, float]]:
        """The z-only container: an empty y stream, the packed z indices
        (14 bits per 64x64 block) and the caption."""
        return frame_container(b"", self.fsq.pack_indices(z_indices),
                               pic_width, pic_height, fp, caption)

    @torch.no_grad()
    def decode(self, fp=None, stream: Optional[bytes] = None):
        """The codec-only decode: a container -> (x_hat control tensor
        (1, ctrl_ch, H/8, W/8), y_semantic, (height, width), (padded
        height, padded width), pad tuple)."""
        if fp is None and stream is None:
            raise ValueError("decode needs fp or stream")
        dec = self.parse(stream if stream is not None else read_from_file(fp))
        z_indices = self.z_indices(dec)
        if self.codec.z_only:
            x_hat, y_semantic = self.codec.decompress_z_only(
                torch.from_numpy(z_indices).to(self.device))
        else:
            coders = self.make_stream_coders([dec["bit_stream_y"]])
            y_hat, z_semantic = self.run_four_part_decode(z_indices, coders)
            x_hat, y_semantic = self.codec.decompress_finish(y_hat,
                                                             z_semantic)
        return (x_hat, y_semantic, (dec["height"], dec["width"]),
                (dec["pad_height"], dec["pad_width"]), dec["pad_tuple"])

    def parse(self, stream: bytes) -> dict:
        """A container's fields (``entropy.framing.decode_i``)."""
        return decode_i(stream, self.fsq.index_bits, self.ds)

    def z_indices(self, dec: dict) -> np.ndarray:
        """A parsed container's z indices, (1, H/64, W/64)."""
        zh, zw = dec["pad_height"] // self.ds, dec["pad_width"] // self.ds
        return self.fsq.unpack_indices(
            dec["bit_stream_z"], zh * zw).reshape(1, zh, zw)

    def make_stream_coders(self, y_streams: Sequence[bytes]):
        """One GaussianConditionalCoder per y bitstream, sharing this
        runtime's CDF bank."""
        cdf_info = self.gaussian_coder.get_cdf_info()
        coders = []
        for ys in y_streams:
            ec = EntropyCoder()
            gc = GaussianConditionalCoder()
            gc.set_cdf_info(*cdf_info)
            gc.entropy_coder = ec
            gc.cdf_group_index = ec.add_cdf(*cdf_info)
            ec.set_stream(ys)
            coders.append(gc)
        return coders

    def _upload(self, symbols: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(narrow_symbols(symbols)).to(self.device)

    @torch.no_grad()
    def run_four_part_decode(self, z_indices: np.ndarray,
                             coders: List[GaussianConditionalCoder],
                             trace=None, stage_done=None):
        """z indices (B, h, w) and one coder per row -> (y_hat, z_semantic),
        both NHWC. ``trace``, if given, is a list that receives the
        host-side (indexes, symbols) of every step, row-stacked;
        ``stage_done``, if given, is called with "begin" after the codec
        begin and with "updates_with_rans" after the 4 steps."""
        n = len(coders)
        if z_indices.shape[0] != n:
            raise ValueError(f"{z_indices.shape[0]} z rows, {n} coders")
        codec = self.codec
        states = [codec.decompress_begin(
            torch.from_numpy(np.ascontiguousarray(z_indices[i:i + 1]))
            .to(self.device)) for i in range(n)]
        if stage_done is not None:
            stage_done("begin")
        for step in range(4):
            idx = np.concatenate([s["indexes_r"].cpu().numpy()
                                  for s in states])
            if n == 1:
                parts = coders[0].decode_stream_with_indexes(idx)
            else:
                parts = GaussianConditionalCoder.decode_streams_with_indexes(
                    coders, idx.reshape(n, -1)).reshape(idx.shape)
            if trace is not None:
                trace.append((idx, parts))
            for i, s in enumerate(states):
                nxt = codec.decompress_update(
                    step, self._upload(parts[i:i + 1]), s["means"],
                    s["y_hat"], s["common"])
                s.update(nxt)
        if stage_done is not None:
            stage_done("updates_with_rans")
        y_hat = torch.cat([s["y_hat"] for s in states])
        z_semantic = torch.cat([s["z_semantic"] for s in states])
        return y_hat, z_semantic
