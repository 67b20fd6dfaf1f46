"""Core conv building blocks, NCHW.

JAX counterpart: ``onedc_tpu/nn/blocks.py``. Attribute names equal the
flax module names, so a flax parameter path maps onto a state-dict key
mechanically (``utils/convert.py``). The JAX package is NHWC; these
modules take and return NCHW tensors (``channels_last`` in memory on the
card, so the NHWC views that the kernels take cost no copy).

Kept from the reference, as in the JAX package: the VQGAN ``nin_shortcut``
applies to the transformed branch, not to the residual input
(``ResnetBlockVQ``).

``Conv2d``, ``Linear`` and ``UpsampleConv2x`` are the modules that the w8a8
serving mode may take (``nn/quant.py``), the counterparts of flax's
``nn.Conv``, ``nn.Dense`` and the JAX ``UpsampleConv2x``; outside a w8a8
scope they are the stock modules.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
from . import quant


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that a w8a8 scope runs in int8 (the conv rule); a 3x3
    conv inside a spatial band takes its halo rows
    (``parallel/spatial.py``)."""

    w8a8_rule = "conv"

    def forward(self, x):
        band = spatial.active()
        if band is not None and self.kernel_size[0] == 3:
            return band.conv(self, x)
        y = quant.intercept(self, x)
        return super().forward(x) if y is None else y


class Linear(nn.Linear):
    """``nn.Linear`` that a w8a8 scope runs in int8 (the dense rule)."""

    w8a8_rule = "dense"

    def forward(self, x):
        y = quant.intercept(self, x)
        return super().forward(x) if y is None else y


def conv1x1(cin: int, cout: int, bias: bool = True) -> Conv2d:
    return Conv2d(cin, cout, 1, bias=bias)


def conv3x3(cin: int, cout: int, bias: bool = True, stride: int = 1,
            groups: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias,
                  groups=groups)


class UpsampleConv2x(nn.Conv2d):
    """``conv3x3(nearest_up_2x(x))``; the parameters of a 3x3 conv.

    The JAX package computes the same function as one lhs-dilated conv at
    input resolution (``nn/blocks.py:39-63``); this is its documented
    equivalent form (``:94-98``), equal up to float reassociation. A w8a8
    scope runs the lhs-dilated form in int8 (``ops/w8a8.py:w8a8_upsample``).
    """

    w8a8_rule = "upsample"

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__(cin, cout, 3, padding=1, bias=bias)

    def forward(self, x):
        band = spatial.active()
        if band is not None:
            return band.upsample_conv(self, x)
        y = quant.intercept(self, x)
        if y is not None:
            return y
        return super().forward(F.interpolate(x, scale_factor=2.0,
                                             mode="nearest"))


def group_norm_affine(x: torch.Tensor, weight, bias, num_groups: int = 32,
                      eps: float = 1e-6):
    """GroupNorm statistics folded into one per-channel affine: returns
    f32 (mul, add), each (B, C), with ``x * mul + add == group_norm(x)``.

    As ``onedc_tpu/nn/blocks.py:219-259``: sums of x and x^2 in f32, and
    the variance E[x^2] - mean^2 clamped at 0 (f32 cancellation can dip
    below it, which gave NaN at B >= 2 in the JAX package's history).
    x is NCHW; inside a spatial band (``parallel/spatial.py``) the sums
    are all-reduced over the bands, the image's statistics.
    """
    b, c = x.shape[:2]
    g = num_groups
    cpg = c // g
    xf = x.float()
    s1 = xf.sum(dim=(2, 3)).view(b, g, cpg).sum(-1)
    s2 = (xf * xf).sum(dim=(2, 3)).view(b, g, cpg).sum(-1)
    n = x.shape[2] * x.shape[3] * cpg
    band = spatial.active()
    if band is not None:
        s1, s2 = band.sum(torch.stack([s1, s2])).unbind()
        n *= band.size
    mean_g = s1 / n
    var_g = torch.clamp_min(s2 / n - mean_g * mean_g, 0.0)
    inv_g = torch.rsqrt(var_g + eps)
    inv_c = inv_g.repeat_interleave(cpg, dim=1)
    mean_c = mean_g.repeat_interleave(cpg, dim=1)
    mul = inv_c * weight.float()
    add = bias.float() - mean_c * mul
    return mul, add


def apply_affine(x: torch.Tensor, mul, add) -> torch.Tensor:
    """x * mul + add per (image, channel) in f32, back in x's dtype."""
    out = x.float() * mul[:, :, None, None] + add[:, :, None, None]
    return out.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW with torch grouping; ``scale`` -> ``weight``."""

    def __init__(self, channels: int, num_groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, return_affine: bool = False):
        mul, add = group_norm_affine(x, self.weight, self.bias,
                                     self.num_groups, self.eps)
        if return_affine:
            return mul, add
        return apply_affine(x, mul, add)


class DepthConv(nn.Module):
    """1x1 -> LeakyReLU -> depthwise 3x3 -> 1x1, residual."""

    def __init__(self, in_ch: int, out_ch: int, slope: float = 0.01):
        super().__init__()
        self.slope = slope
        if in_ch != out_ch:
            self.adaptor = conv1x1(in_ch, out_ch)
        self.conv1_0 = conv1x1(in_ch, in_ch)
        self.depth_conv = conv3x3(in_ch, in_ch, groups=in_ch)
        self.conv2 = conv1x1(in_ch, out_ch)

    def forward(self, x):
        identity = self.adaptor(x) if hasattr(self, "adaptor") else x
        out = F.leaky_relu(self.conv1_0(x), self.slope)
        out = self.conv2(self.depth_conv(out))
        return out + identity


class ConvFFN3(nn.Module):
    """Gated dual-slope FFN."""

    def __init__(self, in_ch: int):
        super().__init__()
        internal = in_ch * 2
        self.conv = conv1x1(in_ch, internal * 2)
        self.conv_out = conv1x1(internal, in_ch)

    def forward(self, x):
        x1, x2 = torch.chunk(self.conv(x), 2, dim=1)
        out = F.leaky_relu(x1, 0.1) + F.leaky_relu(x2, 0.01)
        return x + self.conv_out(out)


class DepthConvBlock4(nn.Module):
    """DepthConv + ConvFFN3."""

    def __init__(self, in_ch: int, out_ch: int, slope_depth_conv=0.01):
        super().__init__()
        self.dc = DepthConv(in_ch, out_ch, slope_depth_conv)
        self.ffn = ConvFFN3(out_ch)

    def forward(self, x):
        return self.ffn(self.dc(x))


class SubpelConv1x1(nn.Module):
    """1x1 conv to r^2 * out channels + pixel shuffle (torch order)."""

    def __init__(self, in_ch: int, out_ch: int, r: int = 2):
        super().__init__()
        self.r = r
        self.conv = conv1x1(in_ch, out_ch * r * r)

    def forward(self, x):
        return F.pixel_shuffle(self.conv(x), self.r)


class ResidualBlockUpsample(nn.Module):
    """Subpel up + conv3x3 with a parallel subpel shortcut."""

    def __init__(self, in_ch: int, out_ch: int, upsample: int = 2):
        super().__init__()
        self.subpel_conv = SubpelConv1x1(in_ch, out_ch, upsample)
        self.conv = conv3x3(out_ch, out_ch)
        self.upsample = SubpelConv1x1(in_ch, out_ch, upsample)

    def forward(self, x):
        out = F.leaky_relu(self.subpel_conv(x), 0.01)
        out = F.leaky_relu(self.conv(out), 0.1)
        return out + self.upsample(x)


class ResnetBlockVQ(nn.Module):
    """VQGAN-style resnet block. With a channel change the 1x1
    ``nin_shortcut`` is applied to the transformed branch (reference
    quirk, ``onedc_tpu/nn/blocks.py:306-308``)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 eps: float = 1e-6):
        super().__init__()
        out_ch = in_ch if out_ch is None else out_ch
        self.norm1 = GroupNorm(in_ch, 32, eps)
        self.conv1 = conv3x3(in_ch, out_ch, bias=False)
        self.norm2 = GroupNorm(out_ch, 32, eps)
        self.conv2 = conv3x3(out_ch, out_ch, bias=False)
        if in_ch != out_ch:
            self.nin_shortcut = conv1x1(out_ch, out_ch, bias=False)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        residual = self.nin_shortcut(h) if hasattr(self, "nin_shortcut") \
            else x
        return h + residual


def tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (B, H*W, C), tokens in row-major pixel order."""
    return x.flatten(2).transpose(1, 2)


def untokens(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, C) -> NCHW."""
    return t.transpose(1, 2).unflatten(2, (h, w))


class AttnBlockVQ(nn.Module):
    """Single-head full self-attention over the spatial grid; q/k/v/proj
    are 1x1 convs. Scores and softmax in f32."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.norm = GroupNorm(c, 32, 1e-6)
        self.q = conv1x1(c, c)
        self.k = conv1x1(c, c)
        self.v = conv1x1(c, c)
        self.proj_out = conv1x1(c, c)

    def forward(self, x):
        _, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = tokens(self.q(hn)), tokens(self.k(hn)), tokens(self.v(hn))
        attn = torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * c ** -0.5
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = untokens(torch.einsum("bqk,bkc->bqc", attn, v), h, w)
        return x + self.proj_out(out)


class ResnetAttnGroup(nn.Module):
    """``res_num`` resnet blocks, then ``attn_num`` attention blocks
    (``onedc_tpu/nn/blocks.py:335-348``)."""

    def __init__(self, channels: int, res_num: int, attn_num: int):
        super().__init__()
        self.res_num = res_num
        self.attn_num = attn_num
        for i in range(res_num):
            self.add_module(f"res{i}", ResnetBlockVQ(channels))
        for i in range(attn_num):
            self.add_module(f"attn{i}", AttnBlockVQ(channels))

    def forward(self, x):
        for i in range(self.res_num):
            x = getattr(self, f"res{i}")(x)
        for i in range(self.attn_num):
            x = getattr(self, f"attn{i}")(x)
        return x


class BottleneckGroup(nn.Module):
    """Resnet - attention - resnet bottleneck (``blocks.py:351-361``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.res0 = ResnetBlockVQ(channels)
        self.attn = AttnBlockVQ(channels)
        self.res1 = ResnetBlockVQ(channels)

    def forward(self, x):
        return self.res1(self.attn(self.res0(x)))


class UpsampleGroup(nn.Module):
    """1x1 conv to 4x channels, pixel shuffle x2, 3x3 conv."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None):
        super().__init__()
        out_ch = in_ch if out_ch is None else out_ch
        self.conv_expand = conv1x1(in_ch, in_ch * 4)
        self.conv_out = conv3x3(in_ch, out_ch)

    def forward(self, x):
        return self.conv_out(F.pixel_shuffle(self.conv_expand(x), 2))
