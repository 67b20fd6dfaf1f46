"""SD1.5 UNet2DConditionModel: the plain text-conditioned UNet of the
stage-II critics (``SD15UNet``) and, with the OneDC control input, the
one-step generator (``SD15CodecUNet``).

JAX counterpart: ``onedc_tpu/nn/unet_sd.py`` (:40-221, :224-286,
:289-373). As in the JAX package:

- ``conv_in`` takes the 320-ch codec control tensor; ``vae_reduction``
  (``ReduceResblock``) turns it into the 4-ch pseudo noisy latent;
- forward returns ``(eps, reduced)``;
- GEGLU uses the exact-erf GELU;
- LayerNorm eps is flax's default 1e-6 (diffusers uses 1e-5): the JAX
  package is the contract here.

Self-attention (``attn1``) at >= 2048 tokens runs the flash kernel K1 on
the card (``nn/attention.py``); cross-attention to the semantic tokens is
plain.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
from .attention import multi_head_attention_bnhd
from .blocks import GroupNorm, Linear, conv1x1, conv3x3, tokens, \
    untokens
from .unet_enc import (
    Downsample2D,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    sinusoidal_time_embedding,
)

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm default


class LayerNorm(nn.LayerNorm):
    """Statistics and affine in f32, result in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LAYER_NORM_EPS)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class CrossAttention(nn.Module):
    """Multi-head attention; self- or cross- depending on ``context``."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        context_dim = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.head_dim = head_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out_0 = Linear(inner, query_dim)

    def forward(self, x, context=None):
        # inside a spatial band, self-attention's queries see every band's
        # keys and values (``parallel/spatial.py``)
        band = spatial.active() if context is None else None
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        q = self.to_q(x).view(b, n, self.heads, self.head_dim)
        k = self.to_k(context).view(b, m, self.heads, self.head_dim)
        v = self.to_v(context).view(b, m, self.heads, self.head_dim)
        route_n = None
        if band is not None:
            k, v = band.gather(k, 1), band.gather(v, 1)
            route_n = n * band.size
        out = multi_head_attention_bnhd(q, k, v, self.head_dim ** -0.5,
                                        route_n)
        return self.to_out_0(out.reshape(b, n, self.heads * self.head_dim))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = torch.chunk(self.proj(x), 2, dim=-1)
        return h * F.gelu(gate)  # exact erf form


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net_0 = GEGLU(dim, dim * mult)
        self.net_2 = Linear(dim * mult, dim)

    def forward(self, x):
        return self.net_2(self.net_0(x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """SpatialTransformer: GN + 1x1 conv projections around one block."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 depth: int = 1):
        super().__init__()
        c = channels
        self.depth = depth
        self.norm = GroupNorm(c, 32, 1e-6)
        self.proj_in = conv1x1(c, c)
        for i in range(depth):
            self.add_module(f"transformer_blocks_{i}", BasicTransformerBlock(
                c, heads, c // heads, context_dim))
        self.proj_out = conv1x1(c, c)

    def forward(self, x, context):
        _, _, h, w = x.shape
        t = tokens(self.proj_in(self.norm(x)))
        for i in range(self.depth):
            t = getattr(self, f"transformer_blocks_{i}")(t, context)
        return self.proj_out(untokens(t, h, w)) + x


class _Block(nn.Module):
    """Resnets (+ attentions) (+ a resampler), named as the flax blocks."""

    def __init__(self, in_chs: Sequence[int], out_ch: int, temb_ch: int,
                 heads: Optional[int], context_dim: int):
        super().__init__()
        self.num_layers = len(in_chs)
        self.has_attn = heads is not None
        for i, cin in enumerate(in_chs):
            self.add_module(f"resnets_{i}",
                            ResnetBlock2D(cin, out_ch, temb_ch))
            if self.has_attn:
                self.add_module(f"attentions_{i}",
                                Transformer2D(out_ch, heads, context_dim))

    def layer(self, i: int, x, temb, context):
        x = getattr(self, f"resnets_{i}")(x, temb)
        if self.has_attn:
            x = getattr(self, f"attentions_{i}")(x, context)
        return x


class DownBlock2D(_Block):
    """CrossAttnDownBlock2D (``heads`` set) or the plain DownBlock2D."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int,
                 heads: Optional[int], context_dim: int, num_layers: int,
                 add_downsample: bool):
        super().__init__([in_ch] + [out_ch] * (num_layers - 1), out_ch,
                         temb_ch, heads, context_dim)
        if add_downsample:
            self.downsamplers_0 = Downsample2D(out_ch)

    def forward(self, x, temb, context) -> Tuple[torch.Tensor, List]:
        skips = []
        for i in range(self.num_layers):
            x = self.layer(i, x, temb, context)
            skips.append(x)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
            skips.append(x)
        return x, skips


class UpBlock2D(_Block):
    """CrossAttnUpBlock2D (``heads`` set) or the plain UpBlock2D; the
    skips are consumed last-in first-out."""

    def __init__(self, in_chs: Sequence[int], out_ch: int, temb_ch: int,
                 heads: Optional[int], context_dim: int,
                 add_upsample: bool):
        super().__init__(in_chs, out_ch, temb_ch, heads, context_dim)
        if add_upsample:
            self.upsamplers_0 = Upsample2D(out_ch)

    def forward(self, x, skips: List, temb, context):
        for i in range(self.num_layers):
            x = torch.cat([x, skips.pop()], dim=1)
            x = self.layer(i, x, temb, context)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x


class MidBlockCrossAttn(nn.Module):
    def __init__(self, channels: int, temb_ch: int, heads: int,
                 context_dim: int):
        super().__init__()
        self.resnets_0 = ResnetBlock2D(channels, channels, temb_ch)
        self.attentions_0 = Transformer2D(channels, heads, context_dim)
        self.resnets_1 = ResnetBlock2D(channels, channels, temb_ch)

    def forward(self, x, temb, context):
        x = self.resnets_0(x, temb)
        x = self.attentions_0(x, context)
        return self.resnets_1(x, temb)


class ReduceResblock(nn.Module):
    """vae_reduction: control tensor -> 4-ch pseudo noisy latent."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, 32, 1e-6)
        self.conv1 = conv3x3(in_ch, in_ch)
        self.norm2 = GroupNorm(in_ch, 32, 1e-6)
        self.conv2 = conv3x3(in_ch, out_ch)
        self.short_cut = conv1x1(in_ch, out_ch)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return h + self.short_cut(x)


class SD15UNet(nn.Module):
    """The standard SD1.5 ``UNet2DConditionModel``: 4-ch latent in and out,
    text cross-attention (JAX ``SD15UNet`` :224), the DMD2 critic pair of
    stage II (``models/dmd.py``).

    forward(sample (B, in_ch, h, w), timesteps (B,), context (B, T,
    context_dim), classify=False) -> eps (B, out_ch, h, w), or with
    ``classify`` the mid-block feature (B, C_last, h/8, w/8) for the GAN
    head (JAX :267)."""

    def __init__(self, in_ch: int = 4, out_ch: int = 4,
                 block_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, attention_head_dim: int = 8,
                 context_dim: int = 768):
        super().__init__()
        self._build(in_ch, out_ch, block_channels, layers_per_block,
                    attention_head_dim, context_dim)

    def _build(self, in_ch, out_ch, block_channels, layers_per_block,
               attention_head_dim, context_dim):
        ch = list(block_channels)
        heads = attention_head_dim  # SD1.5: 8 heads at every level
        temb_ch = ch[0] * 4
        self.ch0 = ch[0]
        self.n_levels = len(ch)
        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)
        self.conv_in = conv3x3(in_ch, ch[0])

        skip_chs = [ch[0]]
        prev = ch[0]
        for i, c in enumerate(ch):
            final = i == len(ch) - 1
            self.add_module(f"down_blocks_{i}", DownBlock2D(
                prev, c, temb_ch, None if final else heads, context_dim,
                layers_per_block, add_downsample=not final))
            skip_chs += [c] * (layers_per_block + (0 if final else 1))
            prev = c

        self.mid_block = MidBlockCrossAttn(ch[-1], temb_ch, heads,
                                           context_dim)

        n_res = layers_per_block + 1
        for i, c in enumerate(reversed(ch)):
            in_chs = []
            for _ in range(n_res):
                in_chs.append(prev + skip_chs.pop())
                prev = c
            self.add_module(f"up_blocks_{i}", UpBlock2D(
                in_chs, c, temb_ch, None if i == 0 else heads, context_dim,
                add_upsample=i < len(ch) - 1))

        self.conv_norm_out = GroupNorm(ch[0], 32, 1e-5)
        self.conv_out = conv3x3(ch[0], out_ch)
        self.n_res = n_res

    def _down_mid(self, sample, timesteps, context):
        """(mid-block feature, skips, temb)."""
        t_emb = sinusoidal_time_embedding(
            timesteps, self.ch0, flip_sin_to_cos=True,
            downscale_freq_shift=0.0)
        temb = self.time_embedding(t_emb.to(sample.dtype))

        h = self.conv_in(sample)
        skips = [h]
        for i in range(self.n_levels):
            h, s = getattr(self, f"down_blocks_{i}")(h, temb, context)
            skips.extend(s)
        return self.mid_block(h, temb, context), skips, temb

    def _up(self, h, skips, temb, context):
        for i in range(self.n_levels):
            blk = skips[-self.n_res:]
            del skips[-self.n_res:]
            h = getattr(self, f"up_blocks_{i}")(h, blk, temb, context)
        h = F.silu(self.conv_norm_out(h))
        return self.conv_out(h)

    def forward(self, sample, timesteps, context, classify: bool = False):
        h, skips, temb = self._down_mid(sample, timesteps, context)
        if classify:
            return h  # the bottleneck feature for the GAN head
        return self._up(h, skips, temb, context)


class SD15CodecUNet(SD15UNet):
    """forward(control (B, in_ch, H/8, W/8), timesteps (B,), context
    (B, T, context_dim)) -> (eps (B, 4, H/8, W/8), reduced (same)): the
    SD1.5 UNet with ``conv_in`` on the codec's control tensor and the
    ``vae_reduction`` branch."""

    def __init__(self, in_ch: int = 320, out_ch: int = 4, vae_ch: int = 4,
                 block_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, attention_head_dim: int = 8,
                 context_dim: int = 768):
        nn.Module.__init__(self)
        # registered first: seeded initialisations and the optimizers walk
        # the parameters in registration order
        self.vae_reduction = ReduceResblock(in_ch, vae_ch)
        self._build(in_ch, out_ch, block_channels, layers_per_block,
                    attention_head_dim, context_dim)

    def forward(self, sample, timesteps, context):
        reduced = self.vae_reduction(sample)
        h, skips, temb = self._down_mid(sample, timesteps, context)
        return self._up(h, skips, temb, context), reduced
