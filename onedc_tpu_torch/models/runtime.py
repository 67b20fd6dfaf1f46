"""Host side of the codec: the encode's rANS write and framing, and the
decode's four-part rANS <-> prior-net loop.

JAX counterpart: ``onedc_tpu/models/runtime.py`` (:75-126 encode,
:130-221 decode). The four-part prior forces 4 host <-> device round
trips per decode: the rANS decode of part i needs the CDF indexes that the
prior net computes from parts < i.

Batch invariance: the CDF index is a truncated log-ratio of a bf16 scale,
so a last-ulp difference in the prior nets can flip an index and desync
rANS. cuDNN picks its algorithm by shape, so a batch of B images need not
give an image the bits it gets alone, as the writer computed them. The
prior programs (``decode_begin``, ``decode_update``) therefore take and
give batched tensors but run the nets one image at a time, on each row's
(1, ...) slice; the serial loop here, the pipelined schedule
(``serving/pipeline.py``) and the exported bundle programs
(``utils/aot.py``) all run these two functions. The rANS decode of all
streams of a bucket is one native call per step, and everything after the
loop runs batched.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.framing import decode_i, read_from_file
from ..entropy.gaussian import GaussianConditionalCoder, make_stream_coders
from ..serving.encoder import frame_container, write_container
from ..serving.pipeline import narrow_symbols, upload
from .codec import LatentCodec


# the keys of a write plan that the host codes
WRITE_KEYS = ("y_q_w", "indexes_w", "z_indices")


def host_arrays(value):
    """A device tensor, or a tuple of them, -> numpy on the host."""
    if isinstance(value, tuple):
        return tuple(host_arrays(v) for v in value)
    return value.cpu().numpy()


def decode_begin(codec: LatentCodec, z_indices: torch.Tensor) -> dict:
    """z indices (B, h, w) -> the batched step-0 state of
    ``LatentCodec.decompress_begin``, computed one row at a time."""
    rows = [codec.decompress_begin(z_indices[i:i + 1])
            for i in range(z_indices.shape[0])]
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def decode_update(codec: LatentCodec, step: int, y_q_r, means, y_hat,
                  common) -> dict:
    """``LatentCodec.decompress_update`` of a batch, one row at a time:
    {"y_hat", "means"} and, but at the last step, "indexes_r"."""
    rows = [codec.decompress_update(step, y_q_r[i:i + 1], means[i:i + 1],
                                    y_hat[i:i + 1], common[i:i + 1])
            for i in range(means.shape[0])]
    keys = ("y_hat", "means") + (("indexes_r",) if step < 3 else ())
    return {k: torch.cat([r[k] for r in rows]) for k in keys}


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
        return make_stream_coders(self.gaussian_coder, y_streams)

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
        st = decode_begin(self.codec, upload(z_indices, self.device))
        if stage_done is not None:
            stage_done("begin")
        for step in range(4):
            idx = st["indexes_r"].cpu().numpy()
            if n == 1:
                parts = coders[0].decode_stream_with_indexes(idx)
            else:
                parts = GaussianConditionalCoder.decode_streams_with_indexes(
                    coders, idx.reshape(n, -1)).reshape(idx.shape)
            if trace is not None:
                trace.append((idx, parts))
            st.update(decode_update(
                self.codec, step, upload(narrow_symbols(parts), self.device),
                st["means"], st["y_hat"], st["common"]))
        if stage_done is not None:
            stage_done("updates_with_rans")
        return st["y_hat"], st["z_semantic"]
