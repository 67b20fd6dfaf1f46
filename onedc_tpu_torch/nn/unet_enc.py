"""Encoder UNet, the analysis-transform backbone of the latent codec, and
the UNet parts it shares with the SD UNet: time embedding, resnet,
down/upsample.

JAX counterpart: ``onedc_tpu/nn/unet_enc.py`` (:31-242). As there: the down
path AttnDown/AttnDown/Down (512, 768, 768), 2 layers per block; a mid block
with attention; the up path AttnUp/AttnUp/Up applied deepest-first, so
attention runs at /64 and /32 on the way up, NOT as a mirror of the down
path (:216-221); fixed t=999 time conditioning; ``conv_in`` replaced by 3
VQGAN resnets and a stride-2 conv, so the UNet runs at /16 with a /64 mid.
Attention has head_dim 8 (channels / 8 heads) and goes through
``multi_head_attention_bnhd``: at 768x768 the /16 level has 2304 tokens and
runs the flash kernel K1 on the card.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import multi_head_attention_bnhd
from .blocks import GroupNorm, Linear, ResnetBlockVQ, UpsampleConv2x, \
    conv1x1, conv3x3, tokens, untokens


def sinusoidal_time_embedding(timesteps: torch.Tensor, dim: int, *,
                              flip_sin_to_cos: bool,
                              downscale_freq_shift: float,
                              max_period: int = 10000) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` semantics, in f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D ('default' time-scale-shift)."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int,
                 eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, groups, eps)
        self.conv1 = conv3x3(in_ch, out_ch)
        self.time_emb_proj = Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(out_ch, groups, eps)
        self.conv2 = conv3x3(out_ch, out_ch)
        if in_ch != out_ch:
            self.conv_shortcut = conv1x1(in_ch, out_ch)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        t = self.time_emb_proj(F.silu(temb))
        h = h + t[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = UpsampleConv2x(channels, channels)

    def forward(self, x):
        return self.conv(x)


class SelfAttention2D(nn.Module):
    """diffusers' deprecated-style attention block of UNet2DModel:
    GroupNorm -> per-pixel q/k/v linears, channels / head_dim heads,
    residual."""

    def __init__(self, channels: int, head_dim: int = 8, eps: float = 1e-5,
                 groups: int = 32):
        super().__init__()
        c = channels
        self.head_dim = head_dim
        self.group_norm = GroupNorm(c, groups, eps)
        self.to_q = Linear(c, c)
        self.to_k = Linear(c, c)
        self.to_v = Linear(c, c)
        self.to_out = Linear(c, c)

    def forward(self, x):
        b, c, h, w = x.shape
        flat = tokens(self.group_norm(x))

        def split(t):
            return t.reshape(b, h * w, c // self.head_dim, self.head_dim)

        out = multi_head_attention_bnhd(
            split(self.to_q(flat)), split(self.to_k(flat)),
            split(self.to_v(flat)), self.head_dim ** -0.5)
        out = self.to_out(out.reshape(b, h * w, c))
        return untokens(out, h, w) + x


class DownBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int,
                 num_layers: int = 2, add_attention: bool = False,
                 add_downsample: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.add_attention = add_attention
        for i in range(num_layers):
            self.add_module(f"resnets_{i}", ResnetBlock2D(
                in_ch if i == 0 else out_ch, out_ch, temb_ch))
            if add_attention:
                self.add_module(f"attentions_{i}", SelfAttention2D(out_ch))
        if add_downsample:
            self.downsamplers_0 = Downsample2D(out_ch)

    def forward(self, x, temb) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        skips = []
        for i in range(self.num_layers):
            x = getattr(self, f"resnets_{i}")(x, temb)
            if self.add_attention:
                x = getattr(self, f"attentions_{i}")(x)
            skips.append(x)
        if hasattr(self, "downsamplers_0"):
            x = self.downsamplers_0(x)
            skips.append(x)
        return x, skips


class UpBlock2D(nn.Module):
    """Consumes its skips most recent first."""

    def __init__(self, in_chs: Sequence[int], out_ch: int, temb_ch: int,
                 add_attention: bool = False, add_upsample: bool = True):
        super().__init__()
        self.num_layers = len(in_chs)
        self.add_attention = add_attention
        for i, cin in enumerate(in_chs):
            self.add_module(f"resnets_{i}", ResnetBlock2D(cin, out_ch,
                                                          temb_ch))
            if add_attention:
                self.add_module(f"attentions_{i}", SelfAttention2D(out_ch))
        if add_upsample:
            self.upsamplers_0 = Upsample2D(out_ch)

    def forward(self, x, skips: List[torch.Tensor], temb):
        for i in range(self.num_layers):
            x = torch.cat([x, skips.pop()], dim=1)
            x = getattr(self, f"resnets_{i}")(x, temb)
            if self.add_attention:
                x = getattr(self, f"attentions_{i}")(x)
        if hasattr(self, "upsamplers_0"):
            x = self.upsamplers_0(x)
        return x


class MidBlock2D(nn.Module):
    def __init__(self, channels: int, temb_ch: int):
        super().__init__()
        self.resnets_0 = ResnetBlock2D(channels, channels, temb_ch)
        self.attentions_0 = SelfAttention2D(channels)
        self.resnets_1 = ResnetBlock2D(channels, channels, temb_ch)

    def forward(self, x, temb):
        x = self.resnets_0(x, temb)
        return self.resnets_1(self.attentions_0(x), temb)


class EncoderUNet(nn.Module):
    """forward(fused pixel + latent embedding (B, in_ch, H/8, W/8)) ->
    (y (B, out_ch, H/16, W/16), sem (B, ch_config[-1], H/64, W/64), the mid
    feature that feeds the semantic hyperprior)."""

    def __init__(self, in_ch: int = 320, out_ch: int = 512,
                 ch_config: Sequence[int] = (512, 768, 768),
                 layers_per_block: int = 2):
        super().__init__()
        ch = list(ch_config)
        ch0 = ch[0]
        temb_ch = ch0 * 4
        self.ch0 = ch0
        self.n_levels = len(ch)
        self.time_embedding = TimestepEmbedding(ch0, temb_ch)
        self.conv_in_res0 = ResnetBlockVQ(in_ch, ch0)
        self.conv_in_res1 = ResnetBlockVQ(ch0, ch0)
        self.conv_in_res2 = ResnetBlockVQ(ch0, ch0)
        self.conv_in_down = conv3x3(ch0, ch0, stride=2)

        down_attention = (True, True, False)
        skip_chs = [ch0]
        prev = ch0
        for i, c in enumerate(ch):
            final = i == len(ch) - 1
            self.add_module(f"down_blocks_{i}", DownBlock2D(
                prev, c, temb_ch, layers_per_block, down_attention[i],
                add_downsample=not final))
            skip_chs += [c] * (layers_per_block + (0 if final else 1))
            prev = c
        self.mid_block = MidBlock2D(ch[-1], temb_ch)

        up_attention = (True, True, False)
        self.n_res = layers_per_block + 1
        for i, c in enumerate(reversed(ch)):
            in_chs = []
            for _ in range(self.n_res):
                in_chs.append(prev + skip_chs.pop())
                prev = c
            self.add_module(f"up_blocks_{i}", UpBlock2D(
                in_chs, c, temb_ch, up_attention[i],
                add_upsample=i < len(ch) - 1))
        self.conv_norm_out = GroupNorm(ch0, 32, 1e-5)
        self.conv_out = conv3x3(ch0, out_ch)

    def forward(self, x):
        t = torch.full((x.shape[0],), 999, dtype=torch.int32, device=x.device)
        t_emb = sinusoidal_time_embedding(
            t, self.ch0, flip_sin_to_cos=True, downscale_freq_shift=0.0)
        temb = self.time_embedding(t_emb.to(x.dtype))
        h = self.conv_in_res2(self.conv_in_res1(self.conv_in_res0(x)))
        h = self.conv_in_down(h)
        skips = [h]
        for i in range(self.n_levels):
            h, s = getattr(self, f"down_blocks_{i}")(h, temb)
            skips.extend(s)
        h = self.mid_block(h, temb)
        sem = h
        for i in range(self.n_levels):
            blk = skips[-self.n_res:]
            del skips[-self.n_res:]
            h = getattr(self, f"up_blocks_{i}")(h, blk, temb)
        y = self.conv_out(F.silu(self.conv_norm_out(h)))
        return y, sem
