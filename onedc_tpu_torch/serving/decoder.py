"""Model-code-free lambda-family serving decoder driven by exported
programs.

JAX counterpart: ``onedc_tpu/serving/decoder.py`` (``ServingDecoder``
:54-149). ``ServingDecoder`` runs the serving schedule
(``serving/pipeline.py``, the same one as the live runtime's
``decode_batch``) from a bundle directory written by ``python -m
onedc_tpu_torch.utils.aot`` plus the weights. It imports no model code:
the nets are ``torch.export`` programs, the host side is the entropy
package's rANS coder and framing, and the z stream unpacks through the
stateless FSQ bit-packing of ``nn/fsq.py``.
"""

from __future__ import annotations

from typing import List

import torch

from ..entropy.coder import EntropyCoder
from ..entropy.framing import decode_i
from ..entropy.gaussian import GaussianConditionalCoder, make_stream_coders
from ..nn.fsq import FSQ  # stateless host bit-packing only
from ..utils.numerics import pinned
from .bundle import Bundle
from .pipeline import DecodePrograms, pipelined_decode

_I8 = tuple(f"update{s}_i8" for s in range(4))


class ServingDecoder:
    """Pipelined lambda decode from a serving bundle.

    ``bundle_dir``: a directory of ``utils/aot.py`` (begin, update*, x0,
    vae programs + meta.json). ``weights``: a state dict, or the path of a
    flat safetensors file of one (``--save-weights``). Runs on the card
    unless given ``device``.
    """

    def __init__(self, bundle_dir, weights, device=None):
        self.bundle = Bundle(bundle_dir, weights, device)
        self.fsq = FSQ(tuple(self.bundle.meta["z_fsq_levels"]))
        # bundles without the int8 update twins pin the symbols to int16
        self._has_i8 = all(self.bundle.has(n) for n in _I8)
        self._coder = GaussianConditionalCoder()
        self._coder.update(EntropyCoder(), force=True)

    def _programs(self) -> DecodePrograms:
        program = self.bundle.program

        def step(yq, m, yh, c, _s):
            # an artifact's signature is fixed: the int8 twin takes the
            # chunks whose symbols the schedule narrowed
            name = (f"update{_s}_i8" if yq.dtype == torch.int8
                    else f"update{_s}")
            return program(name)(yq, m, yh, c)

        return DecodePrograms(
            begin=program("begin"),
            update=[(lambda yq, m, yh, c, _s=s: step(yq, m, yh, c, _s))
                    for s in range(4)],
            x0=program("x0"), vae=program("vae"))

    @pinned
    @torch.no_grad()
    def decode_batch(self, streams: List[bytes]) -> List[torch.Tensor]:
        """Containers -> list of (1, H, W, 3) f32 images in input order.
        Every stream must pad to the bundle's bucket; the exported batch is
        fixed, so a ragged chunk pads up to it (padding rows decode zero
        symbols and are trimmed)."""
        b = self.bundle
        decs = [decode_i(s, self.fsq.index_bits, b.ds) for s in streams]
        for d in decs:
            if (d["pad_height"], d["pad_width"]) != (b.pad_h, b.pad_w):
                raise ValueError(
                    f"stream pads to {d['pad_height']}x{d['pad_width']}, "
                    f"bundle bucket is {b.pad_h}x{b.pad_w}")
        zh, zw = b.pad_h // b.ds, b.pad_w // b.ds
        preds = pipelined_decode(
            self._programs(),
            lambda ys: make_stream_coders(self._coder, ys),
            lambda data: self.fsq.unpack_indices(data, zh * zw),
            decs, zh, zw, b.device,
            mult=b.batch, chunk=b.batch, vae_chunk=b.batch,
            **({} if self._has_i8 else {"narrow": lambda parts: parts}))
        out = []
        for i, d in enumerate(decs):
            pl, pr, pt, pb = d["pad_tuple"]
            h, w = b.pad_h - pt - pb, b.pad_w - pl - pr
            out.append(preds[i:i + 1, :, pt:pt + h, pl:pl + w]
                       .permute(0, 2, 3, 1).float())
        return out
