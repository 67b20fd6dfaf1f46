"""SD-class KL autoencoder with windowed mid-block attention.

JAX counterpart: ``onedc_tpu/nn/vae.py`` (:46-232). SD 2.1 VAE: the encoder
with block channels (128, 256, 512, 512), 2 resnets per level and the
asymmetric (0, 1, 0, 1) pad before each stride-2 downsample (:134-137);
the decoder with the channels reversed and 3 resnets per level; mid-block
attention on non-overlapping ``attn_patch`` windows (single head).

Every ``VaeResnetBlock`` conv goes through ``affine_silu_conv3x3``
(``ops/conv3x3.py``): the GroupNorm statistics are folded into one
per-image affine, and on the card kernel K2 applies it, the SiLU and the
3x3 conv in one pass, so the normalised tensor never reaches device
memory.

``TinyVaeDecoder`` (JAX ``nn/vae.py:250-283``) is the taesd decoder, the
reference's small-VAE option (``use_large_vae=False``): stock convs only,
no hand kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3x3 import affine_silu_conv3x3
from ..parallel import spatial
from .attention import multi_head_attention
from .blocks import GroupNorm, Linear, UpsampleConv2x, conv1x1, conv3x3


def fused_norm_silu_conv(x: torch.Tensor, norm: GroupNorm,
                         conv: nn.Conv2d) -> torch.Tensor:
    """conv(silu(norm(x))) through the fused op; x and the result NCHW
    (channels_last in memory makes both layout changes free, as does
    ``hwio_conv_weights`` for the weight)."""
    mul, add = norm(x, return_affine=True)
    w = conv.weight.permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO
    band = spatial.active()
    keep = slice(None)
    if band is not None:
        # the neighbours' rows on interior sides; the kernel's own zero
        # padding (after the activation) at the image's edges
        x, keep = band.with_halo(x)
    out = affine_silu_conv3x3(x.permute(0, 2, 3, 1).contiguous(), mul, add,
                              w, conv.bias)
    return out.permute(0, 3, 1, 2)[:, :, keep]


@torch.no_grad()
def hwio_conv_weights(module: nn.Module) -> None:
    """Lay every ``VaeResnetBlock`` conv weight out in memory as HWIO, the
    layout K2 reads, once: the parameter keeps its OIHW shape (and its state
    dict entry) as a permuted view, and ``fused_norm_silu_conv`` then takes
    it with no copy."""
    for m in module.modules():
        if isinstance(m, VaeResnetBlock):
            for conv in (m.conv1, m.conv2):
                hwio = conv.weight.permute(2, 3, 1, 0).contiguous()
                conv.weight.data = hwio.permute(3, 2, 0, 1)


class VaeResnetBlock(nn.Module):
    """diffusers VAE ResnetBlock2D (no time embedding). ``conv1`` and
    ``conv2`` hold K2's weights and never run as modules (the JAX
    ``Conv2dParams``), so the w8a8 mode leaves them exact."""

    def __init__(self, in_ch: int, out_ch: int, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, 32, eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(out_ch, 32, eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = conv1x1(in_ch, out_ch)

    def forward(self, x):
        h = fused_norm_silu_conv(x, self.norm1, self.conv1)
        h = fused_norm_silu_conv(h, self.norm2, self.conv2)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


def window_partition(x, p: int):
    """NHWC -> (B * nh * nw, p, p, C) windows."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // p) * (w // p), p, p, c), (b, h // p, w // p)


def window_merge(x, meta, p: int):
    b, nh, nw = meta
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * p, nw * p, c)


class VaeAttention(nn.Module):
    """Single-head mid-block attention, on ``attn_patch`` windows when the
    grid is larger than one window and divisible by it."""

    def __init__(self, channels: int, attn_patch: int = 16,
                 eps: float = 1e-6):
        super().__init__()
        c = channels
        self.attn_patch = attn_patch
        self.group_norm = GroupNorm(c, 32, eps)
        self.to_q = Linear(c, c)
        self.to_k = Linear(c, c)
        self.to_v = Linear(c, c)
        self.to_out = Linear(c, c)

    def forward(self, x):
        _, c, h, w = x.shape
        xn = self.group_norm(x).permute(0, 2, 3, 1)  # NHWC
        p = self.attn_patch
        # a spatial band (``parallel/spatial.py``) decides as the image
        band = spatial.active()
        gh = h * band.size if band is not None else h
        windowed = p > 0 and (gh > p or w > p) and gh % p == 0 and w % p == 0
        if windowed and h % p:
            raise ValueError(f"a band of {h} rows cuts the VAE's "
                             f"{p}-row attention windows")
        if windowed:
            xn, meta = window_partition(xn, p)
        bb, hh, ww, _ = xn.shape
        flat = xn.reshape(bb, hh * ww, c)
        q, k, v = self.to_q(flat), self.to_k(flat), self.to_v(flat)
        route_n = None
        if band is not None and not windowed:  # global: every band's keys
            k, v = band.gather(k, 1), band.gather(v, 1)
            route_n = hh * ww * band.size
        out = multi_head_attention(q[:, None], k[:, None], v[:, None],
                                   c ** -0.5, route_n)[:, 0]
        out = self.to_out(out).reshape(bb, hh, ww, c)
        if windowed:
            out = window_merge(out, meta, p)
        return out.permute(0, 3, 1, 2) + x


class VaeMidBlock(nn.Module):
    def __init__(self, channels: int, attn_patch: int = 16):
        super().__init__()
        self.resnets_0 = VaeResnetBlock(channels, channels)
        self.attentions_0 = VaeAttention(channels, attn_patch)
        self.resnets_1 = VaeResnetBlock(channels, channels)

    def forward(self, x):
        return self.resnets_1(self.attentions_0(self.resnets_0(x)))


class VaeDownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int = 2,
                 add_downsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"resnets_{i}", VaeResnetBlock(
                in_ch if i == 0 else out_ch, out_ch))
        if add_downsample:
            self.downsamplers_0 = nn.Conv2d(out_ch, out_ch, 3, stride=2)

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x)
        if hasattr(self, "downsamplers_0"):
            # diffusers pads (0, 1, 0, 1) before the VALID stride-2 conv
            x = self.downsamplers_0(F.pad(x, (0, 1, 0, 1)))
        return x


class VaeUpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int = 3,
                 add_upsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"resnets_{i}", VaeResnetBlock(
                in_ch if i == 0 else out_ch, out_ch))
        if add_upsample:
            self.upsamplers_0 = UpsampleConv2x(out_ch, out_ch)

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x


class VaeEncoder(nn.Module):
    """image (B, 3, H, W) -> moments (B, 2 * latent_ch, H/8, W/8)."""

    def __init__(self, block_channels: Sequence[int] = (128, 256, 512, 512),
                 latent_ch: int = 4, layers_per_block: int = 2,
                 attn_patch: int = 16):
        super().__init__()
        self.n_levels = len(block_channels)
        self.conv_in = conv3x3(3, block_channels[0])
        prev = block_channels[0]
        for i, c in enumerate(block_channels):
            self.add_module(f"down_blocks_{i}", VaeDownBlock(
                prev, c, layers_per_block,
                add_downsample=i < len(block_channels) - 1))
            prev = c
        self.mid_block = VaeMidBlock(prev, attn_patch)
        self.conv_norm_out = GroupNorm(prev, 32, 1e-6)
        self.conv_out = conv3x3(prev, 2 * latent_ch)
        self.quant_conv = conv1x1(2 * latent_ch, 2 * latent_ch)

    def forward(self, x):
        x = self.conv_in(x)
        for i in range(self.n_levels):
            x = getattr(self, f"down_blocks_{i}")(x)
        x = self.mid_block(x)
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return self.quant_conv(x)


class VaeDecoder(nn.Module):
    def __init__(self, block_channels: Sequence[int] = (128, 256, 512, 512),
                 latent_ch: int = 4, out_ch: int = 3,
                 layers_per_block: int = 3, attn_patch: int = 16):
        super().__init__()
        rev = list(reversed(block_channels))
        self.n_levels = len(rev)
        self.post_quant_conv = conv1x1(latent_ch, latent_ch)
        self.conv_in = conv3x3(latent_ch, rev[0])
        self.mid_block = VaeMidBlock(rev[0], attn_patch)
        prev = rev[0]
        for i, c in enumerate(rev):
            self.add_module(f"up_blocks_{i}", VaeUpBlock(
                prev, c, layers_per_block, add_upsample=i < len(rev) - 1))
            prev = c
        self.conv_norm_out = GroupNorm(rev[-1], 32, 1e-6)
        self.conv_out = conv3x3(rev[-1], out_ch)

    def forward(self, z):
        x = self.conv_in(self.post_quant_conv(z))
        x = self.mid_block(x)
        for i in range(self.n_levels):
            x = getattr(self, f"up_blocks_{i}")(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """The KL VAE; ``encode`` returns the (mean, logvar) moments."""

    def __init__(self, block_channels: Sequence[int] = (128, 256, 512, 512),
                 latent_ch: int = 4, attn_patch: int = 16):
        super().__init__()
        self.encoder = VaeEncoder(block_channels, latent_ch,
                                  attn_patch=attn_patch)
        self.decoder = VaeDecoder(block_channels, latent_ch,
                                  attn_patch=attn_patch)

    def encode(self, x: torch.Tensor):
        """image NCHW -> (mean, logvar clipped to [-30, 20]), each NCHW."""
        mean, logvar = torch.chunk(self.encoder(x), 2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)


# ---------------------------------------------------------------------------
# Tiny VAE decoder (taesd architecture)
# ---------------------------------------------------------------------------

class TaesdBlock(nn.Module):
    """relu(conv(relu(conv(relu(conv(x))))) + skip(x)); the skip is a
    bias-free 1x1 conv when the channels change."""

    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.conv_0 = conv3x3(in_ch, ch)
        self.conv_2 = conv3x3(ch, ch)
        self.conv_4 = conv3x3(ch, ch)
        if in_ch != ch:
            self.skip = conv1x1(in_ch, ch, bias=False)

    def forward(self, x):
        h = F.relu(self.conv_0(x))
        h = F.relu(self.conv_2(h))
        h = self.conv_4(h)
        skip = self.skip(x) if hasattr(self, "skip") else x
        return F.relu(h + skip)


class TinyVaeDecoder(nn.Module):
    """taesd decoder: latent (B, latent_ch, h, w) -> image (B, out_ch, 8h,
    8w), the latent clamped by tanh(z / 3) * 3 first."""

    def __init__(self, ch: int = 64, out_ch: int = 3, latent_ch: int = 4):
        super().__init__()
        self.conv_in = conv3x3(latent_ch, ch)
        for stage in range(3):
            for b in range(3):
                self.add_module(f"stage{stage}_block{b}", TaesdBlock(ch, ch))
            self.add_module(f"stage{stage}_conv",
                            UpsampleConv2x(ch, ch, bias=False))
        self.final_block = TaesdBlock(ch, ch)
        self.conv_out = conv3x3(ch, out_ch)

    def forward(self, z):
        x = F.relu(self.conv_in(torch.tanh(z / 3.0) * 3.0))
        for stage in range(3):
            for b in range(3):
                x = getattr(self, f"stage{stage}_block{b}")(x)
            x = getattr(self, f"stage{stage}_conv")(x)
        return self.conv_out(self.final_block(x))
