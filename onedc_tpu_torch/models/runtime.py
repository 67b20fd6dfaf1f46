"""Host side of the codec decode: the four-part rANS <-> prior-net loop.

JAX counterpart: ``onedc_tpu/models/runtime.py`` (:130-195) and
``onedc_tpu/serving/pipeline.py:58 _narrow_symbols``. The four-part prior
forces 4 host <-> device round trips per decode: the rANS decode of part i
needs the CDF indexes that the prior net computes from parts < i.

Batch invariance: the CDF index is a truncated log-ratio of a bf16 scale,
so a last-ulp difference in the prior nets can flip an index and desync
rANS. cuDNN picks its algorithm by shape, so a batch of B images need not
give an image the bits it gets alone, as the writer computed them. The
prior programs therefore run one image at a time, on the image's own
(1, ...) tensors; the rANS decode of all streams of a bucket is still one
native call per step, and everything after the loop runs batched.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.gaussian import GaussianConditionalCoder
from .codec import LatentCodec


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
