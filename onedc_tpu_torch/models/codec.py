"""Latent codec: the analysis transform g_a, the hyper encoder and decoder,
the rate-distortion training forward, the device half of encode, the
four-part prior programs of the decode and the synthesis transform g_s.

JAX counterpart: ``onedc_tpu/models/codec.py`` (:53-200, :262-349,
:356-415). The per-step programs ``decompress_begin`` /
``decompress_update`` / ``decompress_finish`` keep the JAX package's NHWC
arrays at their boundary (the host rANS loop reads the CDF indexes and
writes the symbols in that layout); the nets inside compute in NCHW. The
training forward runs its four-part prior in NHWC too, so that its noise
and its masks have the JAX layout.

``compress`` builds its write plan from the decoder's own programs, one
image at a time (``decompress_begin``, then at each step the symbols from
y and the state's means, fed to ``decompress_update``): the decoder runs
the prior nets on each image's (1, ...) tensors, and cuDNN picks its
algorithm by shape, so only the same programs on the same shapes give the
writer the indexes the reader will compute, bit for bit. Under the masks
this is the JAX package's arithmetic (``forward_four_part_prior(...,
write=True)``): the same two numbers are added, and ``combine_quarters``
of a masked tensor adds three zeros.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy.bound import add_uniform_noise
from ..entropy.fourpart import (
    combine_quarters,
    decompress_step_update,
    forward_four_part_prior,
    forward_four_part_prior_recon_with_z,
    four_part_masks,
    separate_prior,
)
from ..entropy.gaussian import build_indexes, gaussian_bits
from ..nn.blocks import (
    AttnBlockVQ,
    BottleneckGroup,
    DepthConvBlock4,
    ResidualBlockUpsample,
    ResnetBlockVQ,
    UpsampleGroup,
    conv1x1,
    conv3x3,
)
from ..nn.fsq import FSQ
from ..nn.unet_enc import EncoderUNet


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class CodecEncoder(nn.Module):
    """Analysis transform g_a: image (B, 3, H, W) + VAE latent (B, cond_ch,
    H/8, W/8) -> (y (B, out_ch, H/16, W/16), sem (B, ch_config[-1], H/64,
    W/64))."""

    def __init__(self, in_ch: int = 3, cond_ch: int = 4, out_ch: int = 128,
                 unet_ch_config: Sequence[int] = (512, 768, 768),
                 emb_ch: int = 192, ctrl_ch: int = 320):
        super().__init__()
        ch_16x = unet_ch_config[0]
        self.pix_emb = nn.Conv2d(in_ch, emb_ch, 8, stride=8)
        self.pix_fusion = conv1x1(emb_ch + cond_ch, ctrl_ch)
        self.unet = EncoderUNet(ctrl_ch, ch_16x, unet_ch_config)
        self.tc_bottleneck = BottleneckGroup(ch_16x)
        self.tc_block0 = DepthConvBlock4(ch_16x, ch_16x)
        self.tc_block1 = DepthConvBlock4(ch_16x, out_ch)

    def forward(self, x, cond):
        x_emb = self.pix_fusion(torch.cat([self.pix_emb(x), cond], dim=1))
        y, sem = self.unet(x_emb)
        y = self.tc_block1(self.tc_block0(self.tc_bottleneck(y)))
        return y, sem


class HyperEncoder(nn.Module):
    """y (/16) + sem (/64) -> z (/64, z_ch channels)."""

    def __init__(self, y_ch: int = 128, sem_ch: int = 768,
                 internal_ch: int = 512, z_ch: int = 7):
        super().__init__()
        self.ytc_block0 = DepthConvBlock4(y_ch, y_ch)
        self.ytc_down0 = conv3x3(y_ch, y_ch, stride=2)
        self.ytc_block1 = DepthConvBlock4(y_ch, y_ch)
        self.ytc_down1 = conv3x3(y_ch, y_ch, stride=2)
        self.fusion_block0 = DepthConvBlock4(y_ch + sem_ch, sem_ch)
        self.fusion_attn0 = AttnBlockVQ(sem_ch)
        self.fusion_block1 = DepthConvBlock4(sem_ch, internal_ch)
        self.fusion_attn1 = AttnBlockVQ(internal_ch)
        self.fusion_block2 = DepthConvBlock4(internal_ch, internal_ch)
        self.fusion_out = conv1x1(internal_ch, z_ch)

    def forward(self, y, sem):
        h = self.ytc_down0(self.ytc_block0(y))
        h = self.ytc_down1(self.ytc_block1(h))
        h = self.fusion_block0(torch.cat([h, sem], dim=1))
        h = self.fusion_attn1(self.fusion_block1(self.fusion_attn0(h)))
        return self.fusion_out(self.fusion_block2(h))


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


# the entropy coder clamps symbols to this magnitude before it codes them
# as int16 (``entropy/coder.py``)
SYMBOL_LIMIT = 30000


class LatentCodec(nn.Module):
    """The IntraNoAR-equivalent latent codec: ``forward`` is the
    rate-distortion training / eval forward, ``compress`` the device half
    of encode, the ``decompress_*`` programs the decode.

    ``compute_dtype`` is the dtype the nets run in (bf16 for serving); the
    image, the cond latent, the FSQ codes and the decoded symbols are cast
    to it, as in the JAX package (``models/codec.py:217-229``), and the CDF
    indexes are always computed in f32 (``build_indexes``). ``z_only`` is
    the extreme-low-bpp model: no y stream, y_hat is the prior's predicted
    means.
    """

    def __init__(self, cond_ch: int = 4, ctrl_ch: int = 320,
                 internal_ch: int = 512,
                 bottleneck_ch: int = 128,
                 unet_ch_config: Sequence[int] = (512, 768, 768),
                 z_fsq_levels: Sequence[int] = (4, 4, 4, 4, 4, 4, 4),
                 force_zero_thres: Optional[float] = None,
                 z_only: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        n = bottleneck_ch
        sem_ch = unet_ch_config[-1]
        self.force_zero_thres = force_zero_thres
        self.z_only = z_only
        self.compute_dtype = compute_dtype
        self.ds = 64        # padding granularity
        self.z_vq = FSQ(z_fsq_levels)
        self.enc = CodecEncoder(3, cond_ch, n, unet_ch_config,
                                ctrl_ch=ctrl_ch)
        self.hyper_enc = HyperEncoder(n, sem_ch, internal_ch,
                                      len(z_fsq_levels))
        self.dec = CodecDecoder(n, internal_ch, sem_ch, ctrl_ch)
        self.semantic_adaptor = SemanticAdaptor(n, sem_ch)
        self.hyper_dec = HyperDecoder(n, len(z_fsq_levels))
        self.y_prior_fusion = PriorFusion(n)
        self.y_spatial_prior_reduction = conv1x1(n * 2, n)
        for i in (1, 2, 3):
            self.add_module(f"y_spatial_prior_adaptor_{i}",
                            DepthConvBlock4(n * 2, n * 2))
        self.y_spatial_prior = SpatialPrior(n)

    def _prior_step(self, i: int):
        """NHWC params -> NHWC (scales | means) of step i + 1 (1..3)."""
        adaptor = getattr(self, f"y_spatial_prior_adaptor_{i + 1}")
        return lambda p: nhwc(self.y_spatial_prior(adaptor(nchw(p))))

    def _reduction(self, p):
        return nhwc(self.y_spatial_prior_reduction(nchw(p)))

    def forward(self, x, cond, training: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """The RD forward (``onedc_tpu/models/codec.py:262-311``). x: image
        (B, 3, H, W), padded to a multiple of 64; cond: VAE latent (B,
        cond_ch, H/8, W/8).

        In training the bits of y are estimated on y_res plus U(-0.5, 0.5)
        noise, given as ``noise`` (NHWC, the shape of y: (B, H/16, W/16,
        C), the JAX layout) or drawn from ``generator``; with neither, or
        out of training, on the rounded y_q. Returns the JAX keys: "x_hat",
        "y_hat", "y_semantic", "z_semantic" (NCHW), "z_indices" (B, H/64,
        W/64), "bit", "bpp", "bpp_y", "bpp_hard_y" (scalars).
        """
        pixel_num = x.shape[2] * x.shape[3]
        y, sem = self.enc(x, cond)
        z = self.hyper_enc(y, sem)
        z_hat, z_indices = self.z_vq(nhwc(z))
        params, z_semantic = self.hyper_dec(nchw(z_hat))
        params = self.y_prior_fusion(params)
        steps = [self._prior_step(i) for i in range(3)]
        if self.z_only:
            y_hat = forward_four_part_prior_recon_with_z(
                nhwc(y), nhwc(params), steps, reduction=self._reduction)
            y_res = y_q = torch.zeros_like(y_hat)
            scales_hat = torch.ones_like(y_hat)
        else:
            y_res, y_q, y_hat, scales_hat = forward_four_part_prior(
                nhwc(y), nhwc(params), steps, reduction=self._reduction,
                training=training, force_zero_thres=self.force_zero_thres)
        y_semantic = self.semantic_adaptor(z_semantic)
        x_hat = self.dec(nchw(y_hat), y_semantic)

        if training and noise is not None:
            y_for_bit = y_res + noise
        elif training and generator is not None:
            y_for_bit = add_uniform_noise(y_res, generator)
        else:
            y_for_bit = y_q
        bits_y = gaussian_bits(y_for_bit, scales_hat, training=training)
        bpp_y = (bits_y.sum((1, 2, 3)) / pixel_num).mean()
        bits_hard = gaussian_bits(y_q.detach(), scales_hat,
                                  training=training)
        bpp_hard_y = (bits_hard.sum((1, 2, 3)) / pixel_num).mean()
        return {
            "x_hat": x_hat,
            "y_hat": nchw(y_hat),
            "bit": bpp_y * pixel_num,
            "bpp": bpp_y,
            "bpp_y": bpp_y,
            "bpp_hard_y": bpp_hard_y,
            "y_semantic": y_semantic,
            "z_semantic": z_semantic,
            "z_indices": z_indices,
        }

    @torch.no_grad()
    def compress(self, x, cond) -> Dict[str, object]:
        """The device half of encode (``onedc_tpu/models/codec.py:
        315-349``): x image (B, 3, H, W), padded to a multiple of 64; cond
        the VAE latent (B, cond_ch, H/8, W/8). Returns the JAX keys:
        "z_indices" (B, H/64, W/64) int32 and, unless ``z_only``, the write
        plan: "y_q_w" and "indexes_w", one (B, H/16, W/16, C/4) tensor per
        step (the symbols as int16, clamped to +-SYMBOL_LIMIT as the coder
        clamps them; the CDF indexes, uint8, or int16 with -1 marking a
        skipped symbol under ``force_zero_thres``), and "y_hat" (B, H/16,
        W/16, C), the latent the decoder will rebuild. The encoders may run
        batched; the plan runs one image at a time (see the module
        docstring)."""
        x = x.to(self.compute_dtype)
        cond = cond.to(self.compute_dtype)
        y, sem = self.enc(x, cond)
        z = self.hyper_enc(y, sem)
        _, z_indices = self.z_vq(nhwc(z))
        if self.z_only:
            return {"z_indices": z_indices}
        y = nhwc(y)
        plans = [self._write_plan(y[i:i + 1], z_indices[i:i + 1])
                 for i in range(y.shape[0])]
        return {
            "y_q_w": tuple(torch.cat([p[0][s] for p in plans])
                           for s in range(4)),
            "indexes_w": tuple(torch.cat([p[1][s] for p in plans])
                               for s in range(4)),
            "y_hat": torch.cat([p[2] for p in plans]),
            "z_indices": z_indices,
        }

    def _write_plan(self, y, z_indices):
        """One image's plan through the decoder's programs: y (1, h, w, C)
        NHWC -> ([symbols] * 4, [indexes] * 4, y_hat)."""
        st = self.decompress_begin(z_indices)
        _, h, w, c = y.shape
        masks = four_part_masks(h, w, c, y.dtype, y.device)
        symbols, indexes = [], []
        for step in range(4):
            mask = masks[step]
            sym = combine_quarters(torch.round((y - st["means"] * mask)
                                               * mask))
            sym = sym.clamp(-SYMBOL_LIMIT, SYMBOL_LIMIT).to(torch.int16)
            if self.force_zero_thres is not None:
                sym = torch.where(st["indexes_r"] < 0, 0, sym)
            symbols.append(sym)
            indexes.append(st["indexes_r"])
            st.update(self.decompress_update(step, sym, st["means"],
                                             st["y_hat"], st["common"]))
        return symbols, indexes, st["y_hat"]

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

    def decompress_z_only(self, z_indices):
        """The z-only decode (``onedc_tpu/models/codec.py:408-415``): z
        indices (B, h, w) -> NCHW (x_hat control, y_semantic), y_hat being
        the prior's predicted means."""
        z_hat = nchw(self.z_vq.indices_to_codes(z_indices)).to(
            self.compute_dtype)
        params, z_semantic = self.hyper_dec(z_hat)
        params = nhwc(self.y_prior_fusion(params))
        y_hat = forward_four_part_prior_recon_with_z(
            separate_prior(params)[0], params,
            [self._prior_step(i) for i in range(3)],
            reduction=self._reduction)
        return self.decompress_finish(y_hat, nhwc(z_semantic))
