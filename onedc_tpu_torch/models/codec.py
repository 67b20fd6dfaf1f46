"""Latent codec, decode half: hyper decoder, four-part prior programs and
the synthesis transform g_s.

JAX counterpart: ``onedc_tpu/models/codec.py`` (:78-200, :356-405). The
per-step programs ``decompress_begin`` / ``decompress_update`` /
``decompress_finish`` keep the JAX package's NHWC arrays at their
boundary (the host rANS loop reads the CDF indexes and writes the symbols
in that layout); the nets inside compute in NCHW.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy.fourpart import (
    combine_quarters,
    decompress_step_update,
    four_part_masks,
    separate_prior,
)
from ..entropy.gaussian import build_indexes
from ..nn.blocks import (
    AttnBlockVQ,
    DepthConvBlock4,
    ResidualBlockUpsample,
    ResnetBlockVQ,
    UpsampleGroup,
    conv1x1,
)
from ..nn.fsq import FSQ


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class CodecDecoder(nn.Module):
    """Synthesis transform g_s -> 320-ch control tensor."""

    def __init__(self, in_ch: int = 128, internal_ch: int = 512,
                 semantic_ch: int = 768, out_ch: int = 320):
        super().__init__()
        ch_16x = internal_ch
        ch_8x = internal_ch // 2
        self.tc_block0 = DepthConvBlock4(in_ch, ch_16x)
        self.tc_block1 = DepthConvBlock4(ch_16x, ch_16x)
        for i in range(3):
            self.add_module(f"res16_{i}", ResnetBlockVQ(ch_16x))
        self.up = UpsampleGroup(ch_16x, ch_8x)
        for i in range(3):
            self.add_module(f"res8_{i}", ResnetBlockVQ(ch_8x))
        self.sem_up0 = ResidualBlockUpsample(semantic_ch, ch_16x)
        self.sem_block0 = DepthConvBlock4(ch_16x, ch_16x)
        self.sem_up1 = ResidualBlockUpsample(ch_16x, ch_8x)
        self.sem_block1 = DepthConvBlock4(ch_8x, ch_8x)
        self.sem_up2 = ResidualBlockUpsample(ch_8x, ch_8x)
        self.conv_out = DepthConvBlock4(ch_8x * 2, out_ch)

    def forward(self, y_hat, sem_hat):
        h = self.tc_block1(self.tc_block0(y_hat))
        for i in range(3):
            h = getattr(self, f"res16_{i}")(h)
        h = self.up(h)
        for i in range(3):
            h = getattr(self, f"res8_{i}")(h)
        s = self.sem_block0(self.sem_up0(sem_hat))
        s = self.sem_block1(self.sem_up1(s))
        s = self.sem_up2(s)
        return self.conv_out(torch.cat([h, s], dim=1))


class HyperDecoder(nn.Module):
    """z_hat -> (entropy params at /16, z_semantic tap at /64)."""

    def __init__(self, entropy_ch: int = 128, z_ch: int = 7):
        super().__init__()
        c = entropy_ch
        self.feat_in = conv1x1(z_ch, c)
        self.ent_block0 = DepthConvBlock4(c, c)
        self.ent_up0 = ResidualBlockUpsample(c, c)
        self.ent_block1 = DepthConvBlock4(c, c)
        self.ent_up1 = ResidualBlockUpsample(c, c)
        self.ent_block2 = DepthConvBlock4(c, c)

    def forward(self, z_hat):
        h = F.leaky_relu(self.feat_in(z_hat), 0.01)
        z_semantic = h
        h = self.ent_up0(self.ent_block0(h))
        h = self.ent_up1(self.ent_block1(h))
        return self.ent_block2(h), z_semantic


class SemanticAdaptor(nn.Module):
    """z_semantic (128 @ /64) -> y_semantic (768 @ /64), the UNet's
    cross-attention tokens."""

    def __init__(self, entropy_ch: int = 128, semantic_ch: int = 768):
        super().__init__()
        c = semantic_ch
        self.block_in = DepthConvBlock4(entropy_ch, c)
        for g in range(2):
            self.add_module(f"g{g}_res0", ResnetBlockVQ(c))
            self.add_module(f"g{g}_attn0", AttnBlockVQ(c))
            self.add_module(f"g{g}_attn1", AttnBlockVQ(c))
        self.block_out = DepthConvBlock4(c, c)

    def forward(self, x):
        h = self.block_in(x)
        for g in range(2):
            h = getattr(self, f"g{g}_res0")(h)
            h = getattr(self, f"g{g}_attn0")(h)
            h = getattr(self, f"g{g}_attn1")(h)
        return self.block_out(h)


class PriorFusion(nn.Module):
    """y_prior_fusion: hyper params n -> 2n."""

    def __init__(self, n: int = 128):
        super().__init__()
        self.block0 = DepthConvBlock4(n, n * 2)
        self.block1 = DepthConvBlock4(n * 2, n * 2)

    def forward(self, x):
        return self.block1(self.block0(x))


class SpatialPrior(nn.Module):
    """Shared 3-block spatial prior net."""

    def __init__(self, n: int = 128):
        super().__init__()
        c = n * 2
        self.block0 = DepthConvBlock4(c, c)
        self.block1 = DepthConvBlock4(c, c)
        self.block2 = DepthConvBlock4(c, c)

    def forward(self, x):
        return self.block2(self.block1(self.block0(x)))


class LatentCodec(nn.Module):
    """Decode half of the IntraNoAR-equivalent latent codec.

    ``compute_dtype`` is the dtype the nets run in (bf16 for serving); the
    FSQ codes and the decoded symbols are cast to it, as in the JAX
    package (``models/codec.py:217-229``), and the CDF indexes are always
    computed in f32 (``build_indexes``).
    """

    def __init__(self, ctrl_ch: int = 320, internal_ch: int = 512,
                 bottleneck_ch: int = 128,
                 unet_ch_config: Sequence[int] = (512, 768, 768),
                 z_fsq_levels: Sequence[int] = (4, 4, 4, 4, 4, 4, 4),
                 force_zero_thres: Optional[float] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        n = bottleneck_ch
        sem_ch = unet_ch_config[-1]
        self.force_zero_thres = force_zero_thres
        self.compute_dtype = compute_dtype
        self.ds = 64        # padding granularity
        self.z_vq = FSQ(z_fsq_levels)
        self.dec = CodecDecoder(n, internal_ch, sem_ch, ctrl_ch)
        self.semantic_adaptor = SemanticAdaptor(n, sem_ch)
        self.hyper_dec = HyperDecoder(n, len(z_fsq_levels))
        self.y_prior_fusion = PriorFusion(n)
        self.y_spatial_prior_reduction = conv1x1(n * 2, n)
        for i in (1, 2, 3):
            self.add_module(f"y_spatial_prior_adaptor_{i}",
                            DepthConvBlock4(n * 2, n * 2))
        self.y_spatial_prior = SpatialPrior(n)

    def _rans_indexes(self, scales_r: torch.Tensor) -> torch.Tensor:
        """CDF indexes in the smallest dtype that fits: uint8 (0..255), or
        int16 when force_zero_thres can emit -1 skip markers."""
        idx = build_indexes(scales_r, self.force_zero_thres)
        return idx.to(torch.int16 if self.force_zero_thres is not None
                      else torch.uint8)

    def decompress_begin(self, z_indices: torch.Tensor) -> dict:
        """z indices (B, h, w) -> the step-0 state (NHWC arrays)."""
        z_hat = nchw(self.z_vq.indices_to_codes(z_indices)).to(
            self.compute_dtype)
        params, z_semantic = self.hyper_dec(z_hat)
        params = self.y_prior_fusion(params)
        common = nhwc(self.y_spatial_prior_reduction(params))
        scales, means = separate_prior(nhwc(params))
        b, h, w, c = means.shape
        masks = four_part_masks(h, w, c, means.dtype, means.device)
        return {
            "common": common,
            "z_semantic": nhwc(z_semantic),
            "means": means,
            "indexes_r": self._rans_indexes(
                combine_quarters(scales * masks[0])),
            "y_hat": torch.zeros_like(means),
        }

    def decompress_update(self, step: int, y_q_r, means, y_hat_so_far,
                          common) -> dict:
        """Fold in the decoded symbols of ``step``; emit the indexes of
        ``step + 1``."""
        y_q_r = y_q_r.to(means.dtype)
        b, h, w, c = means.shape
        masks = four_part_masks(h, w, c, means.dtype, means.device)
        y_hat = decompress_step_update(y_q_r, means, masks[step], y_hat_so_far)
        if step == 3:
            return {"y_hat": y_hat, "means": means, "indexes_r": None}
        adaptor = getattr(self, f"y_spatial_prior_adaptor_{step + 1}")
        params = nchw(torch.cat([y_hat, common], dim=-1))
        nxt = nhwc(self.y_spatial_prior(adaptor(params)))
        scales, means = separate_prior(nxt)
        return {"y_hat": y_hat, "means": means,
                "indexes_r": self._rans_indexes(
                    combine_quarters(scales * masks[step + 1]))}

    def decompress_finish(self, y_hat, z_semantic):
        """NHWC y_hat, z_semantic -> NCHW (x_hat control, y_semantic)."""
        y_semantic = self.semantic_adaptor(nchw(z_semantic))
        return self.dec(nchw(y_hat), y_semantic), y_semantic
