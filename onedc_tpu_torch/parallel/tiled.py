"""Tiled high-resolution (4K) encode and decode.

JAX counterpart: ``onedc_tpu/parallel/tiled.py`` (``plan_tiles`` :31,
``_ramp_weight`` :45, ``TiledCodec`` :55). The image is cut into
``tile`` x ``tile`` blocks that overlap by ``overlap`` pixels; each tile
is coded as an independent bitstream, and the decoded tiles are blended
with linear ramps across the overlaps (``overlap=0``: hard tiling).

Container, as the JAX package writes it: magic ``ODTC``, then ``>HHHII``
(tile, rows, cols, height, width), one ``>I`` length per tile, then the
tiles' containers (each an ``encode_i`` frame).

``mesh`` (``parallel/mesh.py``), as in JAX, passes on to the runtime's
batch codecs: each ``data`` rank codes its share of the tiles and every
rank returns the whole container or image.

Differences from the JAX ``TiledCodec``:
- encode sends the tiles through ``OneDCRuntime.encode_many``, in device
  chunks of ``ONEDC_PIPELINE_CHUNK`` (8) tiles, where JAX sends all of them
  through ``encode_batch`` as one batch (the 18 tiles of a 3840x2160 image
  at 768 would be one device batch). On the CPU the containers are the
  JAX package's byte for byte;
- decode sends every tile through ``decode_batch``, the pipelined serving
  schedule on the card, and blends on the runtime's device in f32, in the
  JAX package's corner order (a 3840x2160 image is ~100 MB of
  accumulators);
- a contract error raises ValueError where JAX asserts.

The contract's two faults are kept, as JAX has them: the container stores
no overlap, so the decoder must be built with the encoder's (a wrong one
raises only when the tile count differs, and mis-stitches silently when it
matches); and an image with one side at most ``tile`` and the other above
it encodes into tiles smaller than ``tile``, which decode cannot blend
against the ``tile`` x ``tile`` weight.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..entropy.framing import read_from_file, write_to_file

MAGIC = b"ODTC"
_HEAD = ">HHHII"


def plan_tiles(height: int, width: int, tile: int,
               overlap: int = 0) -> List[Tuple[int, int]]:
    """Top-left corners of a covering tile grid with given overlap."""
    step = tile - overlap
    ys = list(range(0, max(height - tile, 0) + 1, step))
    xs = list(range(0, max(width - tile, 0) + 1, step))
    if not ys or ys[-1] + tile < height:
        ys.append(max(height - tile, 0))
    if not xs or xs[-1] + tile < width:
        xs.append(max(width - tile, 0))
    return [(y, x) for y in ys for x in xs]


def _ramp_weight(tile: int, overlap: int) -> np.ndarray:
    """2D blending weight: linear ramps across the overlap bands."""
    w1d = np.ones(tile, np.float32)
    if overlap > 0:
        ramp = np.linspace(0.0, 1.0, overlap + 2)[1:-1]
        w1d[:overlap] = ramp
        w1d[-overlap:] = ramp[::-1]
    return w1d[:, None] * w1d[None, :]


def split_container(data: bytes) -> Tuple[Tuple[int, ...], List[bytes]]:
    """An ``ODTC`` container -> ((tile, rows, cols, height, width), the
    tiles' containers in corner order)."""
    off = len(MAGIC)
    head = struct.unpack_from(_HEAD, data, off)
    off += struct.calcsize(_HEAD)
    n = head[1] * head[2]
    lengths = struct.unpack_from(f">{n}I", data, off)
    off += 4 * n
    subs = []
    for ln in lengths:
        subs.append(data[off:off + ln])
        off += ln
    return head, subs


class TiledCodec:
    """An ``OneDCRuntime`` with tiled high-resolution coding: ``encode``
    of a (1, H, W, 3) image in [-1, 1] -> (container, info dict);
    ``decode`` -> (1, H, W, 3) f32 on the runtime's device."""

    def __init__(self, runtime, tile: int = 768, overlap: int = 64,
                 mesh=None):
        if tile % runtime.ds or overlap % 2:
            raise ValueError(f"tile {tile} must be a multiple of "
                             f"{runtime.ds} and overlap {overlap} even")
        self.rt = runtime
        self.tile = tile
        self.overlap = overlap
        self.mesh = mesh

    # -- encode -------------------------------------------------------------

    def encode(self, image, fp=None) -> Tuple[bytes, dict]:
        """image (1, H, W, 3), torch or numpy. An image whose sides are
        both at most ``tile`` is ``runtime.encode``'s plain container;
        a larger one is cut at ``plan_tiles``' corners, each tile an
        independent bitstream."""
        _, h, w, _ = image.shape
        if max(h, w) <= self.tile:
            return self.rt.encode(image, fp=fp)
        corners = plan_tiles(h, w, self.tile, self.overlap)
        tiles = [image[:, ty:ty + self.tile, tx:tx + self.tile, :]
                 for ty, tx in corners]
        results = self.rt.encode_many(tiles, mesh=self.mesh)
        streams = [s for s, _ in results]
        bits_total = sum(b["bits_total"] for _, b in results)

        rows = len({c[0] for c in corners})
        cols = len({c[1] for c in corners})
        head = MAGIC + struct.pack(_HEAD, self.tile, rows, cols, h, w)
        head += struct.pack(f">{len(streams)}I", *[len(s) for s in streams])
        total = head + b"".join(streams)
        if fp:
            write_to_file(total, fp)
        pix = h * w
        return total, {
            "bits_total": len(total) * 8,
            "bpp": len(total) * 8 / pix,
            "bpp_tiles": bits_total / pix,
            "n_tiles": len(streams),
        }

    # -- decode -------------------------------------------------------------

    def decode(self, fp=None, stream: Optional[bytes] = None
               ) -> torch.Tensor:
        """A container from ``stream`` or the file ``fp``: a plain one
        through ``runtime.decode``, a tiled one through ``decode_batch`` of
        its tiles and the ramp blend."""
        data = stream if stream is not None else read_from_file(fp)
        if not data.startswith(MAGIC):
            return self.rt.decode(data)
        (tile, _, _, h, w), subs = split_container(data)
        corners = plan_tiles(h, w, tile, self.overlap)
        if len(corners) != len(subs):
            raise ValueError(f"the container holds {len(subs)} tiles, the "
                             f"decoder's overlap {self.overlap} plans "
                             f"{len(corners)}: decode with the encoder's "
                             f"overlap")
        tiles = self.rt.decode_batch(subs, mesh=self.mesh)

        device = self.rt.device
        acc = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
        wacc = torch.zeros((h, w, 1), dtype=torch.float32, device=device)
        weight = torch.from_numpy(_ramp_weight(tile, self.overlap))[
            :, :, None].to(device)
        for (ty, tx), til in zip(corners, tiles):
            if til.shape[1:3] != (tile, tile):
                raise ValueError(f"a {til.shape[1]}x{til.shape[2]} tile "
                                 f"cannot blend against the {tile}x{tile} "
                                 f"weight: an image with one side at most "
                                 f"the tile and the other above it is not "
                                 f"decodable")
            acc[ty:ty + tile, tx:tx + tile] += til[0] * weight
            wacc[ty:ty + tile, tx:tx + tile] += weight
        return (acc / torch.clamp(wacc, min=1e-8))[None]
