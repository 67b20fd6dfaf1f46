"""The spatially split decode: one image's rows over the mesh's ``tensor``
axis.

JAX counterpart: ``onedc_tpu/parallel/spatial.py``. There GSPMD splits
the heavy decode programs by their activations' H dim from sharding
anchors alone. The port splits them explicitly, in three places, each
active only inside a band (``Band``, entered by the programs that
``enable_spatial_decode`` installs):

- a 3x3 conv takes its halo rows: each band's boundary rows are
  all-gathered over the group and the conv runs on the band plus the rows
  of its neighbours (``Band.conv``; zero rows at the image's edges, the
  conv's own padding), stride 1 or 2 (a band of even rows starts on an
  even row). ``UpsampleConv2x`` gathers its halo before the upsample.
  K2 (``ops/conv3x3.py``, GroupNorm-affine + SiLU + conv) gets the
  neighbours' rows of its pre-activation input on interior sides only and
  keeps its own zero padding at the image's edges; the rows the halo
  produced are cropped, so the kernel is unchanged;
- GroupNorm's per-group sums of x and x^2 (``nn/blocks.py:
  group_norm_affine``, the one place every GroupNorm goes through) are
  all-reduced over the bands before the mean and the clamped variance;
- self-attention's keys and values are all-gathered, so each band's
  queries see every key (``nn/unet_sd.py:CrossAttention``, the VAE's
  mid-block attention when it is global); K1 or the plain version is
  chosen by the image's token counts, as the single decode chooses
  (``nn/attention.py:can_flash``), not by the band's. Cross-attention to
  the semantic tokens is not split.

Only ``all_gather`` and ``all_reduce`` are used (no point-to-point sends),
so the collectives are the same on NCCL and on gloo.

What is split and what is not (JAX :35-43, 93-99): the programs after the
bitstream, ``OneDC.decode_device_x0`` (the UNet and x0; the codec finish
before it runs whole on every rank, replicated), ``decode_device_vae`` and
``decode_device_z_only`` (hence ``decode``, ``decode_batch``, the
pipelined schedule and ``TiledCodec``). The prior programs (begin and
update) and every encode stay replicated: they are coupled to the
bitstream, and another reduction order could move a CDF index. Each
program all-gathers its result, so every rank returns the whole image.

Documented differences: a split that leaves a band of fractional rows at
any UNet level (the latent's rows must divide by ``tensor x 2^(levels -
1)``), or VAE attention windows across a band's edge, raises ValueError;
GSPMD pads instead. The w8a8 mode is not split (ValueError).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .mesh import TENSOR_AXIS

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("onedc_band",
                                                         default=None)


def active() -> Optional["Band"]:
    """The band that the running program computes, or None."""
    return _ACTIVE.get()


class Band:
    """This rank's rows of an image split over ``group``'s ``size`` ranks
    (rank ``index`` holds the ``index``-th run of equal rows)."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size

    @contextlib.contextmanager
    def entered(self):
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This band's rows of a whole NCHW tensor."""
        n = x.shape[2] // self.size
        return x[:, :, self.index * n:(self.index + 1) * n]

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every band's ``x`` concatenated along ``dim`` in band order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the bands (a new tensor)."""
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def halo(self, x: torch.Tensor):
        """(row above, row below) of an NCHW band: the neighbours' edge
        rows, None at the image's top and bottom."""
        edges = self.gather(torch.cat([x[:, :, :1], x[:, :, -1:]], 2)[None],
                            0)
        top = edges[self.index - 1][:, :, 1:] if self.index > 0 else None
        bottom = (edges[self.index + 1][:, :, :1]
                  if self.index < self.size - 1 else None)
        return top, bottom

    def padded(self, x: torch.Tensor) -> torch.Tensor:
        """The band with one row of each neighbour, zeros at the image's
        edges (a 3x3 conv's padding there)."""
        top, bottom = self.halo(x)
        zero = torch.zeros_like(x[:, :, :1])
        return torch.cat([zero if top is None else top, x,
                          zero if bottom is None else bottom], 2)

    def conv(self, conv: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """A 3x3 conv with padding 1 (stride 1 or 2) of the band: the conv
        over the band and its halo, unpadded in H."""
        return F.conv2d(self.padded(x), conv.weight, conv.bias, conv.stride,
                        (0, conv.padding[1]), conv.dilation, conv.groups)

    def upsample_conv(self, conv: torch.nn.Conv2d, x: torch.Tensor
                      ) -> torch.Tensor:
        """``conv3x3(nearest_up_2x(x))`` of the band: the halo taken
        before the upsample (it becomes two rows), the extra rows cropped."""
        up = F.interpolate(self.padded(x), scale_factor=2.0, mode="nearest")
        return F.conv2d(up, conv.weight, conv.bias, 1, (0, conv.padding[1])
                        )[:, :, 1:-1]

    def with_halo(self, x: torch.Tensor):
        """(x with the neighbours' rows on interior sides only, the rows to
        keep of a same-padded conv's output of it): for K2, whose zero
        padding applies after its activation."""
        top, bottom = self.halo(x)
        parts = [t for t in (top, x, bottom) if t is not None]
        start = 0 if top is None else 1
        return torch.cat(parts, 2), slice(start, start + x.shape[2])


class SpatialPrograms:
    """The runtime's post-bitstream programs split by rows over a group:
    ``x0``, ``vae`` and ``z_only`` take and return whole tensors, as the
    runtime's own (``models/onedc.py:OneDCRuntime``)."""

    def __init__(self, model, band: Band, large: bool):
        self.model, self.band, self.large = model, band, large

    def _check(self, latent_rows: int, levels: int = 1) -> None:
        unit = self.band.size * 2 ** (levels - 1)
        if latent_rows % unit:
            raise ValueError(
                f"a spatial split over {self.band.size} bands needs latent "
                f"rows in multiples of {unit} (every band whole at each "
                f"of {levels} levels); the image has {latent_rows}")

    def _x0_of(self, x_hat, y_semantic):
        self._check(x_hat.shape[2], self.model.unet.n_levels)
        with self.band.entered():
            x0 = self.model._one_step_x0(self.band.rows(x_hat), y_semantic)
        return self.band.gather(x0.to(x_hat.dtype), 2)

    def x0(self, y_hat, z_semantic):
        """Codec finish (whole, on every rank), then the UNet and x0 by
        bands."""
        x_hat, y_semantic = self.model.codec.decompress_finish(y_hat,
                                                               z_semantic)
        return self._x0_of(x_hat, y_semantic)

    def vae(self, x0):
        self._check(x0.shape[2])
        with self.band.entered():
            image = self.model.decode_device_vae(self.band.rows(x0),
                                                 self.large)
        return self.band.gather(image, 2)

    def z_only(self, z_indices):
        x_hat, y_semantic = self.model.codec.decompress_z_only(z_indices)
        return self.vae(self._x0_of(x_hat, y_semantic))


def enable_spatial_decode(rt, mesh):
    """Split ``rt``'s (an ``OneDCRuntime``) post-bitstream programs over
    ``mesh``'s ``tensor`` axis, in place; returns ``rt``. Every rank of a
    ``tensor`` group must decode the same streams (as the data axis hands
    them out)."""
    if rt.quant is not None:
        raise ValueError(f"quant={rt.quant!r}: the spatial decode splits "
                         f"the exact programs only")
    band = Band(mesh[TENSOR_AXIS].get_group(), mesh.get_local_rank(
        TENSOR_AXIS), mesh[TENSOR_AXIS].size())
    programs = SpatialPrograms(rt.model, band, rt.use_large_vae)
    rt.decode_x0 = programs.x0
    rt.decode_vae = lambda x0, large=None: programs.vae(x0)
    rt.decode_z_only = lambda z, large=None: programs.z_only(z)
    return rt
