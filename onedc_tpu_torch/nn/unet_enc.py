"""UNet parts shared with the encoder UNet: time embedding, resnet,
down/upsample.

JAX counterpart: ``onedc_tpu/nn/unet_enc.py`` (:31-80, :113-128). The
encoder UNet itself belongs to the encode slice and is not here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import GroupNorm, UpsampleConv2x, conv1x1, conv3x3


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
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D ('default' time-scale-shift)."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int,
                 eps: float = 1e-5, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, groups, eps)
        self.conv1 = conv3x3(in_ch, out_ch)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch)
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
