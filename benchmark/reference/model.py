"""The plain reference of the OneDC decode: the codec's hyper decoder, the
four-part prior, the synthesis transform, the SD1.5 codec UNet at t = 999,
the x0 recovery and the KL VAE decoder, in plain PyTorch.

No hand kernel, no fused op, no cache and no batching across images: every
convolution is ``F.conv2d``, every norm ``F.group_norm`` / ``F.layer_norm``,
every attention a softmax of explicit scores. It computes in the dtype of
its weights (float32 for the check; TF32 is switched off by
``plain_numerics``). The module tree and parameter names follow the
published architecture as the state dict of the served model names it
(``codec.*``, ``unet.*``, ``vae.decoder.*``), so one dict of seeded
tensors feeds both sides. It imports nothing of the program.

Departures from the published model, each shared with the program: the
VAE mid-block attends within 16 x 16 windows (``vae_attn_patch``), and x0
is recovered in float32.

``attention_log`` and ``conv_log``, when set to lists, receive the shapes
of each attention and of each GroupNorm + SiLU + 3x3 convolution of a VAE
resnet block: the work the roofline metrics count.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# shapes of the work the roofline metrics count (None: not recorded)
attention_log: Optional[List[tuple]] = None
conv_log: Optional[List[tuple]] = None


@contextlib.contextmanager
def plain_numerics():
    """float32 products in float32: TF32 off for cuDNN and cuBLAS."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor, back in
    its own dtype."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)


def fp8_products(module: nn.Module) -> nn.Module:
    """Every convolution of ``module`` takes its weights and its input in
    float8 e4m3 (each tensor under one scale), in place: the precision
    below bfloat16, for the control of a bf16 writer."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.data = fp8(m.weight.data)
            m.register_forward_pre_hook(
                lambda _, args: (fp8(args[0]),) + tuple(args[1:]))
    return module


def attention(q, k, v, scale: float):
    """(B, H, N, D) x (B, H, M, D) -> (B, H, N, D), scores and softmax in
    float32."""
    if attention_log is not None:
        b, h, n, d = q.shape
        attention_log.append((b, n, h, d, k.shape[2]))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = s.softmax(dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def conv1x1(cin, cout, bias=True):
    return nn.Conv2d(cin, cout, 1, bias=bias)


def conv3x3(cin, cout, bias=True, stride=1, groups=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias,
                     groups=groups)


class GroupNorm(nn.Module):
    def __init__(self, c, groups=32, eps=1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


class UpsampleConv2x(nn.Conv2d):
    """conv3x3 of the nearest 2x upsampling."""

    def __init__(self, cin, cout, bias=True):
        super().__init__(cin, cout, 3, padding=1, bias=bias)

    def forward(self, x):
        return super().forward(F.interpolate(x, scale_factor=2.0,
                                             mode="nearest"))


def tokens(x):
    return x.flatten(2).transpose(1, 2)


def untokens(t, h, w):
    return t.transpose(1, 2).unflatten(2, (h, w))


# -- codec blocks ------------------------------------------------------------

class DepthConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        if cin != cout:
            self.adaptor = conv1x1(cin, cout)
        self.conv1_0 = conv1x1(cin, cin)
        self.depth_conv = conv3x3(cin, cin, groups=cin)
        self.conv2 = conv1x1(cin, cout)

    def forward(self, x):
        identity = self.adaptor(x) if hasattr(self, "adaptor") else x
        out = F.leaky_relu(self.conv1_0(x), 0.01)
        return self.conv2(self.depth_conv(out)) + identity


class ConvFFN3(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv = conv1x1(c, c * 4)
        self.conv_out = conv1x1(c * 2, c)

    def forward(self, x):
        a, b = torch.chunk(self.conv(x), 2, dim=1)
        return x + self.conv_out(F.leaky_relu(a, 0.1) + F.leaky_relu(b, 0.01))


class DepthConvBlock4(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.dc = DepthConv(cin, cout)
        self.ffn = ConvFFN3(cout)

    def forward(self, x):
        return self.ffn(self.dc(x))


class SubpelConv1x1(nn.Module):
    def __init__(self, cin, cout, r=2):
        super().__init__()
        self.r = r
        self.conv = conv1x1(cin, cout * r * r)

    def forward(self, x):
        return F.pixel_shuffle(self.conv(x), self.r)


class ResidualBlockUpsample(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.subpel_conv = SubpelConv1x1(cin, cout)
        self.conv = conv3x3(cout, cout)
        self.upsample = SubpelConv1x1(cin, cout)

    def forward(self, x):
        out = F.leaky_relu(self.subpel_conv(x), 0.01)
        out = F.leaky_relu(self.conv(out), 0.1)
        return out + self.upsample(x)


class ResnetBlockVQ(nn.Module):
    """VQGAN resnet block; with a channel change the 1x1 shortcut applies
    to the transformed branch, as the published code has it."""

    def __init__(self, cin, cout=None):
        super().__init__()
        cout = cin if cout is None else cout
        self.norm1 = GroupNorm(cin)
        self.conv1 = conv3x3(cin, cout, bias=False)
        self.norm2 = GroupNorm(cout)
        self.conv2 = conv3x3(cout, cout, bias=False)
        if cin != cout:
            self.nin_shortcut = conv1x1(cout, cout, bias=False)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        res = self.nin_shortcut(h) if hasattr(self, "nin_shortcut") else x
        return h + res


class AttnBlockVQ(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q, self.k, self.v = conv1x1(c, c), conv1x1(c, c), conv1x1(c, c)
        self.proj_out = conv1x1(c, c)

    def forward(self, x):
        _, c, h, w = x.shape
        hn = self.norm(x)
        q, k, v = (tokens(m(hn))[:, None] for m in (self.q, self.k, self.v))
        out = attention(q, k, v, c ** -0.5)[:, 0]
        return x + self.proj_out(untokens(out, h, w))


class UpsampleGroup(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv_expand = conv1x1(cin, cin * 4)
        self.conv_out = conv3x3(cin, cout)

    def forward(self, x):
        return self.conv_out(F.pixel_shuffle(self.conv_expand(x), 2))


class CodecDecoder(nn.Module):
    def __init__(self, in_ch, internal_ch, semantic_ch, out_ch):
        super().__init__()
        c16, c8 = internal_ch, internal_ch // 2
        self.tc_block0 = DepthConvBlock4(in_ch, c16)
        self.tc_block1 = DepthConvBlock4(c16, c16)
        for i in range(3):
            self.add_module(f"res16_{i}", ResnetBlockVQ(c16))
        self.up = UpsampleGroup(c16, c8)
        for i in range(3):
            self.add_module(f"res8_{i}", ResnetBlockVQ(c8))
        self.sem_up0 = ResidualBlockUpsample(semantic_ch, c16)
        self.sem_block0 = DepthConvBlock4(c16, c16)
        self.sem_up1 = ResidualBlockUpsample(c16, c8)
        self.sem_block1 = DepthConvBlock4(c8, c8)
        self.sem_up2 = ResidualBlockUpsample(c8, c8)
        self.conv_out = DepthConvBlock4(c8 * 2, out_ch)

    def forward(self, y_hat, sem):
        h = self.tc_block1(self.tc_block0(y_hat))
        for i in range(3):
            h = getattr(self, f"res16_{i}")(h)
        h = self.up(h)
        for i in range(3):
            h = getattr(self, f"res8_{i}")(h)
        s = self.sem_block0(self.sem_up0(sem))
        s = self.sem_up2(self.sem_block1(self.sem_up1(s)))
        return self.conv_out(torch.cat([h, s], dim=1))


class HyperDecoder(nn.Module):
    def __init__(self, c, z_ch):
        super().__init__()
        self.feat_in = conv1x1(z_ch, c)
        self.ent_block0 = DepthConvBlock4(c, c)
        self.ent_up0 = ResidualBlockUpsample(c, c)
        self.ent_block1 = DepthConvBlock4(c, c)
        self.ent_up1 = ResidualBlockUpsample(c, c)
        self.ent_block2 = DepthConvBlock4(c, c)

    def forward(self, z_hat):
        h = F.leaky_relu(self.feat_in(z_hat), 0.01)
        sem = h
        h = self.ent_up0(self.ent_block0(h))
        h = self.ent_up1(self.ent_block1(h))
        return self.ent_block2(h), sem


class SemanticAdaptor(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.block_in = DepthConvBlock4(cin, c)
        for g in range(2):
            self.add_module(f"g{g}_res0", ResnetBlockVQ(c))
            self.add_module(f"g{g}_attn0", AttnBlockVQ(c))
            self.add_module(f"g{g}_attn1", AttnBlockVQ(c))
        self.block_out = DepthConvBlock4(c, c)

    def forward(self, x):
        h = self.block_in(x)
        for g in range(2):
            for name in ("res0", "attn0", "attn1"):
                h = getattr(self, f"g{g}_{name}")(h)
        return self.block_out(h)


class Chain(nn.Module):
    """block0 -> block1 (-> block2): the prior fusion and spatial prior."""

    def __init__(self, chans: Sequence[int]):
        super().__init__()
        self.n = len(chans) - 1
        for i in range(self.n):
            self.add_module(f"block{i}", DepthConvBlock4(chans[i],
                                                         chans[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"block{i}")(x)
        return x


# the four-part prior: step -> channel quarter -> spatial phase (2*(h%2)+w%2)
PHASES = ((0, 1, 2, 3), (3, 2, 1, 0), (2, 3, 0, 1), (1, 0, 3, 2))


def four_part_masks(h, w, c, device):
    """Four (1, C, H, W) float masks, one per coding step."""
    phase = (torch.arange(h, device=device)[:, None] % 2) * 2 \
        + torch.arange(w, device=device)[None, :] % 2
    quarter = torch.arange(c, device=device) // (c // 4)
    want = torch.as_tensor(PHASES, device=device)[:, quarter]  # (4, C)
    return [(phase[None] == want[s][:, None, None]).float()[None]
            for s in range(4)]


def quarters_sum(x):
    """(B, C, H, W) -> (B, C/4, H, W): the four channel quarters added."""
    a, b, c, d = torch.chunk(x, 4, dim=1)
    return (a + b) + (c + d)


class Codec(nn.Module):
    """The decode half of the latent codec (names as the served model's
    ``codec.*``)."""

    def __init__(self, n, internal_ch, sem_ch, ctrl_ch, z_levels):
        super().__init__()
        self.levels = list(z_levels)
        self.hyper_dec = HyperDecoder(n, len(z_levels))
        self.y_prior_fusion = Chain([n, 2 * n, 2 * n])
        self.y_spatial_prior_reduction = conv1x1(2 * n, n)
        for i in (1, 2, 3):
            self.add_module(f"y_spatial_prior_adaptor_{i}",
                            DepthConvBlock4(2 * n, 2 * n))
        self.y_spatial_prior = Chain([2 * n] * 4)
        self.semantic_adaptor = SemanticAdaptor(n, sem_ch)
        self.dec = CodecDecoder(n, internal_ch, sem_ch, ctrl_ch)

    def z_codes(self, z_indices):
        """FSQ indices (B, h, w) -> codes (B, dim, h, w) in [-1, 1], the
        least significant digit first."""
        levels = torch.as_tensor(self.levels, device=z_indices.device)
        basis = torch.cumprod(torch.cat([levels.new_ones(1), levels[:-1]]),
                              0)
        digits = (z_indices.long()[..., None] // basis) % levels
        half = (levels // 2).float()
        return ((digits.float() - half) / half).permute(0, 3, 1, 2)

    def prior(self, z_indices, symbols=None, dtype=torch.float32):
        """The four-part prior: (y_hat (B, C, h, w), z_semantic, scales of
        the four steps). ``symbols(step, scales)`` gives the decoded
        integer symbols (B, C/4, h, w) of a step from that step's scales;
        None is the z-only model, whose y_hat is the predicted means."""
        params, z_sem = self.hyper_dec(self.z_codes(z_indices).to(dtype))
        params = self.y_prior_fusion(params)
        common = self.y_spatial_prior_reduction(params)
        scales, means = torch.chunk(params, 2, dim=1)
        b, c, h, w = means.shape
        masks = four_part_masks(h, w, c, means.device)
        y_hat = torch.zeros_like(means)
        all_scales = []
        for step in range(4):
            if step:
                adaptor = getattr(self, f"y_spatial_prior_adaptor_{step}")
                nxt = self.y_spatial_prior(adaptor(torch.cat([y_hat, common],
                                                             dim=1)))
                scales, means = torch.chunk(nxt, 2, dim=1)
            mask = masks[step].to(means.dtype)
            all_scales.append(quarters_sum(scales * mask))
            if symbols is None:
                y_hat = y_hat + means * mask
            else:
                sym = symbols(step, all_scales[-1]).to(means.dtype)
                y_hat = y_hat + (sym.repeat(1, 4, 1, 1) + means) * mask
        return y_hat, z_sem, all_scales

    def finish(self, y_hat, z_sem):
        sem = self.semantic_adaptor(z_sem)
        return self.dec(y_hat, sem), sem


# -- the SD1.5 codec UNet ----------------------------------------------------

def time_embedding(t, dim):
    """diffusers ``get_timestep_embedding`` with flip_sin_to_cos, shift 0."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.linear_1, self.linear_2 = nn.Linear(cin, c), nn.Linear(c, c)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, temb_ch):
        super().__init__()
        self.norm1 = GroupNorm(cin, 32, 1e-5)
        self.conv1 = conv3x3(cin, cout)
        self.time_emb_proj = nn.Linear(temb_ch, cout)
        self.norm2 = GroupNorm(cout, 32, 1e-5)
        self.conv2 = conv3x3(cout, cout)
        if cin != cout:
            self.conv_shortcut = conv1x1(cin, cout)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, dim, heads, head_dim, context_dim=None):
        super().__init__()
        inner = heads * head_dim
        ctx = dim if context_dim is None else context_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out_0 = nn.Linear(inner, dim)

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, _ = x.shape

        def heads(t):
            return t.view(b, -1, self.heads, self.head_dim).transpose(1, 2)

        out = attention(heads(self.to_q(x)), heads(self.to_k(context)),
                        heads(self.to_v(context)), self.head_dim ** -0.5)
        return self.to_out_0(out.transpose(1, 2).reshape(b, n, -1))


class GEGLU(nn.Module):
    def __init__(self, din, dout):
        super().__init__()
        self.proj = nn.Linear(din, dout * 2)

    def forward(self, x):
        h, gate = torch.chunk(self.proj(x), 2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.net_0 = GEGLU(dim, dim * 4)
        self.net_2 = nn.Linear(dim * 4, dim)

    def forward(self, x):
        return self.net_2(self.net_0(x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, context_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, heads, dim // heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, heads, dim // heads, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, c, heads, context_dim):
        super().__init__()
        self.norm = GroupNorm(c, 32, 1e-6)
        self.proj_in = conv1x1(c, c)
        self.transformer_blocks_0 = BasicTransformerBlock(c, heads,
                                                          context_dim)
        self.proj_out = conv1x1(c, c)

    def forward(self, x, context):
        _, _, h, w = x.shape
        t = self.transformer_blocks_0(tokens(self.proj_in(self.norm(x))),
                                      context)
        return self.proj_out(untokens(t, h, w)) + x


class UNetBlock(nn.Module):
    def __init__(self, in_chs, cout, temb_ch, heads, context_dim,
                 down=False, up=False):
        super().__init__()
        self.n = len(in_chs)
        self.attn = heads is not None
        for i, cin in enumerate(in_chs):
            self.add_module(f"resnets_{i}", ResnetBlock2D(cin, cout, temb_ch))
            if self.attn:
                self.add_module(f"attentions_{i}",
                                Transformer2D(cout, heads, context_dim))
        if down:
            self.downsamplers_0 = nn.Module()
            self.downsamplers_0.conv = conv3x3(cout, cout, stride=2)
        if up:
            self.upsamplers_0 = nn.Module()
            self.upsamplers_0.conv = UpsampleConv2x(cout, cout)

    def layer(self, i, x, temb, context):
        x = getattr(self, f"resnets_{i}")(x, temb)
        if self.attn:
            x = getattr(self, f"attentions_{i}")(x, context)
        return x


class CodecUNet(nn.Module):
    """SD1.5 UNet with ``conv_in`` on the control tensor and the
    ``vae_reduction`` branch: (control, t, context) -> (eps, reduced)."""

    def __init__(self, in_ch, out_ch, vae_ch, ch, context_dim, heads=8,
                 layers=2):
        super().__init__()
        self.vae_reduction = nn.Module()
        r = self.vae_reduction
        r.norm1, r.conv1 = GroupNorm(in_ch), conv3x3(in_ch, in_ch)
        r.norm2, r.conv2 = GroupNorm(in_ch), conv3x3(in_ch, vae_ch)
        r.short_cut = conv1x1(in_ch, vae_ch)
        temb = ch[0] * 4
        self.ch0, self.levels, self.n_res = ch[0], len(ch), layers + 1
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.conv_in = conv3x3(in_ch, ch[0])
        skips, prev = [ch[0]], ch[0]
        for i, c in enumerate(ch):
            last = i == len(ch) - 1
            self.add_module(f"down_blocks_{i}", UNetBlock(
                [prev] + [c] * (layers - 1), c, temb, None if last else heads,
                context_dim, down=not last))
            skips += [c] * (layers + (0 if last else 1))
            prev = c
        self.mid_block = nn.Module()
        self.mid_block.resnets_0 = ResnetBlock2D(prev, prev, temb)
        self.mid_block.attentions_0 = Transformer2D(prev, heads, context_dim)
        self.mid_block.resnets_1 = ResnetBlock2D(prev, prev, temb)
        for i, c in enumerate(reversed(ch)):
            in_chs = []
            for _ in range(self.n_res):
                in_chs.append(prev + skips.pop())
                prev = c
            self.add_module(f"up_blocks_{i}", UNetBlock(
                in_chs, c, temb, None if i == 0 else heads, context_dim,
                up=i < len(ch) - 1))
        self.conv_norm_out = GroupNorm(ch[0], 32, 1e-5)
        self.conv_out = conv3x3(ch[0], out_ch)

    def forward(self, x, t, context):
        r = self.vae_reduction
        h = r.conv1(F.silu(r.norm1(x)))
        reduced = r.conv2(F.silu(r.norm2(h))) + r.short_cut(x)
        temb = self.time_embedding(time_embedding(t, self.ch0).to(x.dtype))
        h = self.conv_in(x)
        skips = [h]
        for i in range(self.levels):
            blk = getattr(self, f"down_blocks_{i}")
            for j in range(blk.n):
                h = blk.layer(j, h, temb, context)
                skips.append(h)
            if hasattr(blk, "downsamplers_0"):
                h = blk.downsamplers_0.conv(h)
                skips.append(h)
        m = self.mid_block
        h = m.resnets_1(m.attentions_0(m.resnets_0(h, temb), context), temb)
        for i in range(self.levels):
            blk = getattr(self, f"up_blocks_{i}")
            for j in range(blk.n):
                h = blk.layer(j, torch.cat([h, skips.pop()], dim=1), temb,
                              context)
            if hasattr(blk, "upsamplers_0"):
                h = blk.upsamplers_0.conv(h)
        return self.conv_out(F.silu(self.conv_norm_out(h))), reduced


# -- the KL VAE decoder ------------------------------------------------------

class VaeResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(cin), conv3x3(cin, cout)
        self.norm2, self.conv2 = GroupNorm(cout), conv3x3(cout, cout)
        if cin != cout:
            self.conv_shortcut = conv1x1(cin, cout)

    def norm_silu_conv(self, x, norm, conv):
        if conv_log is not None:
            b, cin, h, w = x.shape
            conv_log.append((b, h, w, cin, conv.out_channels))
        return conv(F.silu(norm(x)))

    def forward(self, x):
        h = self.norm_silu_conv(x, self.norm1, self.conv1)
        h = self.norm_silu_conv(h, self.norm2, self.conv2)
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class VaeAttention(nn.Module):
    """Single-head attention within ``patch`` x ``patch`` windows where the
    grid is larger than one window and divisible by it, else global."""

    def __init__(self, c, patch):
        super().__init__()
        self.patch = patch
        self.group_norm = GroupNorm(c)
        self.to_q, self.to_k = nn.Linear(c, c), nn.Linear(c, c)
        self.to_v, self.to_out = nn.Linear(c, c), nn.Linear(c, c)

    def forward(self, x):
        b, c, h, w = x.shape
        p = self.patch
        xn = self.group_norm(x).permute(0, 2, 3, 1)
        windowed = p > 0 and (h > p or w > p) and h % p == 0 and w % p == 0
        if windowed:
            xn = xn.reshape(b, h // p, p, w // p, p, c).permute(
                0, 1, 3, 2, 4, 5).reshape(-1, p, p, c)
        bb, hh, ww, _ = xn.shape
        flat = xn.reshape(bb, hh * ww, c)
        q, k, v = (m(flat)[:, None] for m in (self.to_q, self.to_k,
                                               self.to_v))
        out = self.to_out(attention(q, k, v, c ** -0.5)[:, 0])
        out = out.reshape(bb, hh, ww, c)
        if windowed:
            out = out.reshape(b, h // p, w // p, p, p, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        return out.permute(0, 3, 1, 2) + x


class VaeDecoder(nn.Module):
    def __init__(self, block_channels, latent_ch, patch, layers=3):
        super().__init__()
        rev = list(reversed(block_channels))
        self.post_quant_conv = conv1x1(latent_ch, latent_ch)
        self.conv_in = conv3x3(latent_ch, rev[0])
        self.mid_block = nn.Module()
        self.mid_block.resnets_0 = VaeResnetBlock(rev[0], rev[0])
        self.mid_block.attentions_0 = VaeAttention(rev[0], patch)
        self.mid_block.resnets_1 = VaeResnetBlock(rev[0], rev[0])
        self.n_levels, self.layers = len(rev), layers
        prev = rev[0]
        for i, c in enumerate(rev):
            blk = nn.Module()
            for j in range(layers):
                blk.add_module(f"resnets_{j}",
                               VaeResnetBlock(prev if j == 0 else c, c))
            if i < len(rev) - 1:
                blk.upsamplers_0 = UpsampleConv2x(c, c)
            self.add_module(f"up_blocks_{i}", blk)
            prev = c
        self.conv_norm_out = GroupNorm(rev[-1])
        self.conv_out = conv3x3(rev[-1], 3)

    def forward(self, z):
        x = self.conv_in(self.post_quant_conv(z))
        m = self.mid_block
        x = m.resnets_1(m.attentions_0(m.resnets_0(x)))
        for i in range(self.n_levels):
            blk = getattr(self, f"up_blocks_{i}")
            for j in range(self.layers):
                x = getattr(blk, f"resnets_{j}")(x)
            if hasattr(blk, "upsamplers_0"):
                x = blk.upsamplers_0(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


def alphas_cumprod(steps=1000, beta_start=0.00085, beta_end=0.012):
    """SD1.5's scaled-linear schedule, float64."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, steps) ** 2
    return np.cumprod(1.0 - betas)


class OneDCDecoder(nn.Module):
    """The whole decode after the bitstream: ``prior`` then ``image``."""

    def __init__(self, model: dict):
        super().__init__()
        g = dict(model)
        unet_ch = g.get("unet_ch_config", [512, 768, 768])
        self.codec = Codec(g.get("bottleneck_ch", 128),
                           g.get("internal_ch", 512), unet_ch[-1],
                           g.get("ctrl_ch", 320),
                           g.get("z_fsq_levels", [4] * 7))
        self.unet = CodecUNet(g.get("ctrl_ch", 320), g.get("vae_ch", 4),
                              g.get("vae_ch", 4),
                              g.get("sd_block_channels",
                                    [320, 640, 1280, 1280]),
                              g.get("context_dim", 768))
        self.vae = nn.Module()
        self.vae.decoder = VaeDecoder(
            g.get("vae_block_channels", [128, 256, 512, 512]),
            g.get("vae_ch", 4), g.get("vae_attn_patch", 16))
        self.scaling = g.get("vae_scaling_factor", 0.18215)
        self.t = g.get("conditioning_timestep", 999)
        self.abar = float(alphas_cumprod()[self.t])

    def image(self, y_hat, z_sem):
        """NCHW y_hat, z_semantic -> image (B, 3, H, W), float32 x0."""
        x_hat, sem = self.codec.finish(y_hat, z_sem)
        t = torch.full((x_hat.shape[0],), self.t, device=x_hat.device)
        eps, reduced = self.unet(x_hat, t, tokens(sem))
        x0 = (reduced.float() - math.sqrt(1.0 - self.abar) * eps.float()) \
            / math.sqrt(self.abar)
        return self.vae.decoder(x0.to(y_hat.dtype) / self.scaling)
