"""The reference decode of one container: parse, z indices, the four-part
prior with the rANS decode of the y stream (none for a z-only stream),
the codec finish, the UNet at t = 999, x0 and the VAE decoder, in plain
PyTorch at the dtype of ``model``'s weights.

A lambda stream decodes only under the CDF indexes its writer used, and
those are a bucketing of scales that the writer computed in its own
arithmetic: one index that lands in the next bucket desyncs the rest of
the stream. So the y symbols are decoded under the indexes given as
``indexes`` (the writer's, as the program's encoder computes them), and
the reference's own indexes, computed from its float32 scales, are
counted against them (``stats``): the share that differ and the share
more than one bucket away. Those two shares are compared for ``correct``,
so a writer whose scales depart from the reference's is caught.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import entropy
from .model import OneDCDecoder, plain_numerics


def y_symbols(stream: bytes, indexes: Optional[Sequence[np.ndarray]]
              ) -> Optional[List[np.ndarray]]:
    """The y symbols of the 4 steps, each in the shape of its step's
    indexes (1, h, w, C/4); None for a z-only stream. The symbols depend
    on the indexes alone, so one decode serves every model."""
    y = entropy.parse(stream)["y"]
    if not y:
        return None
    if indexes is None:
        raise ValueError("a y stream needs its writer's indexes")
    coder = entropy.YDecoder(y)
    return [coder.decode(np.asarray(indexes[s])) for s in range(4)]


@torch.no_grad()
def decode(model: OneDCDecoder, stream: bytes, device,
           symbols: Optional[Sequence[np.ndarray]] = None,
           indexes: Optional[Sequence[np.ndarray]] = None, stats=None):
    """Container bytes -> image (1, H, W, 3) float32, NHWC, unpadded.
    ``symbols``: ``y_symbols`` of the stream; ``indexes``: the writer's CDF
    indexes of the 4 steps, each (1, h, w, C/4); ``stats``, a dict that
    receives the counts of the reference's own indexes against them."""
    dec = entropy.parse(stream)
    z = torch.from_numpy(entropy.z_indices(dec)).to(device)
    dtype = next(model.parameters()).dtype

    def given(step, scales):
        if stats is not None:
            own = entropy.scale_indexes(scales).permute(0, 2, 3, 1)
            own = own.cpu().numpy().astype(np.int64)
            diff = np.abs(own - np.asarray(indexes[step]).astype(np.int64))
            stats["indexes"] = stats.get("indexes", 0) + diff.size
            stats["differ"] = stats.get("differ", 0) + int((diff > 0).sum())
            stats["far"] = stats.get("far", 0) + int((diff > 1).sum())
        return torch.from_numpy(symbols[step].astype(np.float32)).permute(
            0, 3, 1, 2).to(device)

    with plain_numerics():
        y_hat, z_sem, _ = model.codec.prior(
            z, None if symbols is None else given, dtype)
        image = model.image(y_hat, z_sem)
    return image[:, :, :dec["height"], :dec["width"]].permute(
        0, 2, 3, 1).float()


@torch.no_grad()
def writer_indexes(model: OneDCDecoder, z: torch.Tensor,
                   symbols: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The CDF indexes that ``model``'s prior gives the 4 steps of a write
    plan: z indices (B, h, w) and each step's symbols (B, h, w, C/4) ->
    4 int arrays (B, h, w, C/4)."""
    out = []
    dtype = next(model.parameters()).dtype

    def record(step, scales):
        out.append(entropy.scale_indexes(scales).permute(0, 2, 3, 1)
                   .cpu().numpy().astype(np.int64))
        return symbols[step].permute(0, 3, 1, 2).float()

    with plain_numerics():
        model.codec.prior(z, record, dtype)
    return out
