"""The host half of encode (rANS-code a write plan and frame the
container) and the model-code-free bundle encoder.

JAX counterpart: ``onedc_tpu/serving/encoder.py`` (``write_container``
:35-78, the one host-side encode bridge, shared by the live runtime and
the bundle encoder; ``ServingEncoder`` :81-163). ``ServingEncoder`` runs
a bundle's ``encode`` program (``utils/aot.py``: the VAE posterior mean
and the codec's write plan) and writes the containers here; it imports no
model code, and its containers are byte-identical to the live runtime's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.framing import encode_i, filesize, get_padding_size, \
    write_to_file
from ..entropy.gaussian import GaussianConditionalCoder
from ..nn.fsq import FSQ  # stateless host bit-packing only
from ..utils.numerics import pinned


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


def pad_replicate(image: torch.Tensor, pad) -> torch.Tensor:
    """NHWC image, replicate-padded by (left, right, top, bottom)."""
    pl, pr, pt, pb = pad
    _, h, w, _ = image.shape
    rows = torch.arange(-pt, h + pb, device=image.device).clamp(0, h - 1)
    cols = torch.arange(-pl, w + pr, device=image.device).clamp(0, w - 1)
    return image[:, rows][:, :, cols]


class ServingEncoder:
    """Batched lambda encode from a serving bundle (no model code).

    ``bundle_dir``: a directory of ``utils/aot.py`` with ``encode.pt2`` and
    meta.json. ``weights``: a state dict, or the path of a flat
    safetensors file of one. Runs on the card unless given ``device``.
    """

    def __init__(self, bundle_dir, weights, device=None):
        from .bundle import Bundle

        self.bundle = Bundle(bundle_dir, weights, device)
        self._encode = self.bundle.program("encode")
        self.fsq = FSQ(tuple(self.bundle.meta["z_fsq_levels"]))
        self._coder = GaussianConditionalCoder()
        self._coder.update(EntropyCoder(), force=True)

    def _padded(self, image) -> torch.Tensor:
        """One (1, H, W, 3) image, cast and replicate-padded to the bucket,
        NHWC on the bundle's device (as ``OneDCRuntime.pad``)."""
        b = self.bundle
        im = torch.as_tensor(image, device=b.device).to(b.dtype)
        _, h, w, _ = im.shape
        pad = get_padding_size(h, w, b.ds)
        pl, pr, pt, pb = pad
        if (h + pt + pb, w + pl + pr) != (b.pad_h, b.pad_w):
            raise ValueError(f"image pads to {h + pt + pb}x{w + pl + pr}, "
                             f"bundle bucket is {b.pad_h}x{b.pad_w}")
        return pad_replicate(im, pad)

    @pinned
    @torch.no_grad()
    def encode_batch(self, images: Sequence,
                     captions: Optional[List[str]] = None
                     ) -> List[Tuple[bytes, Dict[str, float]]]:
        """(1, H, W, 3) images in [-1, 1] -> [(container, bpp dict)] in
        input order. Every image must pad to the bundle's bucket; chunks
        pad up to the exported batch (the padding rows' plans are
        dropped). Every chunk is queued before the host writes any
        container."""
        from .pipeline import start_fetch

        b = self.bundle
        caps = list(captions) if captions is not None else [""] * len(images)
        if len(caps) != len(images):
            raise ValueError(f"{len(caps)} captions for {len(images)} images")
        queued = []
        for c0 in range(0, len(images), b.batch):
            sel = list(range(c0, min(c0 + b.batch, len(images))))
            batch = torch.cat([self._padded(images[i]) for i in sel])
            if batch.shape[0] < b.batch:  # ragged chunk: repeat the last
                batch = torch.cat([batch] + [batch[-1:]]
                                  * (b.batch - batch.shape[0]))
            plan = self._encode(batch.permute(0, 3, 1, 2))
            queued.append((sel, {
                "y_q_w": [start_fetch(a) for a in plan["y_q_w"]],
                "indexes_w": [start_fetch(a) for a in plan["indexes_w"]],
                "z_indices": start_fetch(plan["z_indices"])}))
        results: List = [None] * len(images)
        for sel, fetched in queued:
            y_q_w = [f() for f in fetched["y_q_w"]]
            idx_w = [f() for f in fetched["indexes_w"]]
            z = fetched["z_indices"]()
            for j, i in enumerate(sel):
                _, h, w, _ = images[i].shape
                per = {"y_q_w": [a[j:j + 1] for a in y_q_w],
                       "indexes_w": [a[j:j + 1] for a in idx_w],
                       "z_indices": z[j:j + 1]}
                results[i] = write_container(
                    self._coder.entropy_coder, self._coder, self.fsq, per,
                    w, h, caption=caps[i])
        return results
