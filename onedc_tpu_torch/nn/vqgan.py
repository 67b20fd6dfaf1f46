"""MaskGIT-VQGAN tokenizer, NCHW: the frozen target of the Codeformer's
semantic distillation.

JAX counterpart: ``onedc_tpu/nn/vqgan.py`` (``VQGANEncoder`` :24,
``VQGANDecoder`` :54, ``VectorQuantizer`` :83, ``MaskGitVQGAN`` :125):
channel_mult (1, 1, 2, 2, 4), hidden 128, 2 res blocks, z 256, a codebook
of 1024 x 256; 2x2 average-pool downsampling, nearest + conv upsampling,
the resnet blocks' ``nin_shortcut`` on the transformed branch (the
reference's quirk, kept in ``nn/blocks.py:ResnetBlockVQ``). Takes [0, 1]
images. Attribute names are the flax module names (``utils/convert.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import GroupNorm, ResnetBlockVQ, UpsampleConv2x, conv1x1, \
    conv3x3


class VQGANEncoder(nn.Module):
    def __init__(self, hidden: int = 128,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, z_channels: int = 256):
        super().__init__()
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = conv3x3(3, hidden, bias=False)
        mults = (1,) + self.channel_mult
        for i, mult in enumerate(self.channel_mult):
            block_out = hidden * mult
            for j in range(num_res_blocks):
                block_in = hidden * mults[i] if j == 0 else block_out
                self.add_module(f"down_{i}_block_{j}",
                                ResnetBlockVQ(block_in, block_out))
        mid = hidden * self.channel_mult[-1]
        for j in range(num_res_blocks):
            self.add_module(f"mid_{j}", ResnetBlockVQ(mid, mid))
        self.norm_out = GroupNorm(mid, 32, 1e-6)
        self.conv_out = conv1x1(mid, z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        n = len(self.channel_mult)
        for i in range(n):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != n - 1:
                h = F.avg_pool2d(h, 2)
        for j in range(self.num_res_blocks):
            h = getattr(self, f"mid_{j}")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VQGANDecoder(nn.Module):
    def __init__(self, hidden: int = 128,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, z_channels: int = 256,
                 out_channels: int = 3):
        super().__init__()
        self.channel_mult = tuple(channel_mult)
        self.num_res_blocks = num_res_blocks
        n = len(self.channel_mult)
        top = hidden * self.channel_mult[-1]
        self.conv_in = conv3x3(z_channels, top)
        for j in range(num_res_blocks):
            self.add_module(f"mid_{j}", ResnetBlockVQ(top, top))
        for i in reversed(range(n)):
            block_out = hidden * self.channel_mult[i]
            prev = top if i == n - 1 else hidden * self.channel_mult[i + 1]
            for j in range(num_res_blocks):
                self.add_module(f"up_{i}_block_{j}", ResnetBlockVQ(
                    prev if j == 0 else block_out, block_out))
            if i != 0:
                self.add_module(f"up_{i}_conv",
                                UpsampleConv2x(block_out, block_out))
        bottom = hidden * self.channel_mult[0]
        self.norm_out = GroupNorm(bottom, 32, 1e-6)
        self.conv_out = conv3x3(bottom, out_channels)

    def forward(self, z):
        h = self.conv_in(z)
        for j in range(self.num_res_blocks):
            h = getattr(self, f"mid_{j}")(h)
        for i in reversed(range(len(self.channel_mult))):
            for j in range(self.num_res_blocks):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != 0:
                h = getattr(self, f"up_{i}_conv")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


def _sq_distances(flat: torch.Tensor, embedding: torch.Tensor):
    """|x|² - 2 x·e + |e|², (N, K), as the JAX package sums it."""
    return (flat.pow(2).sum(1, keepdim=True) - 2 * flat @ embedding.T
            + embedding.pow(2).sum(1)[None])


class VectorQuantizer(nn.Module):
    """Nearest-neighbour VQ with a (num_embeddings, dim) codebook; takes
    and returns NHWC."""

    def __init__(self, num_embeddings: int = 1024, embedding_dim: int = 256):
        super().__init__()
        self.embedding_dim = embedding_dim
        # flax's variance_scaling(1.0, "fan_in", "uniform") on (K, D)
        bound = (3.0 / num_embeddings) ** 0.5
        self.embedding = nn.Parameter(
            torch.empty(num_embeddings, embedding_dim).uniform_(-bound,
                                                                bound))

    def forward(self, h) -> Tuple[torch.Tensor, torch.Tensor]:
        """h (B, H, W, D) -> (quantized (B, H, W, D), straight-through;
        indices (B, H, W))."""
        flat = h.reshape(-1, self.embedding_dim)
        idx = _sq_distances(flat, self.embedding).argmin(1)
        quant = self.embedding[idx].reshape(h.shape)
        return h + (quant - h).detach(), idx.reshape(h.shape[:-1])

    def get_codebook_entry(self, indices):
        return self.embedding[indices]

    def get_soft_code(self, h, temp: float = 1.0):
        """Softmax of the negative squared distances over the codebook,
        (B, H, W, K)."""
        flat = h.reshape(-1, self.embedding_dim)
        soft = (-_sq_distances(flat, self.embedding) / temp).softmax(-1)
        return soft.reshape(*h.shape[:-1], self.embedding.shape[0])


class MaskGitVQGAN(nn.Module):
    """The frozen tokenizer: [0, 1] images (B, 3, H, W) -> 1024-way code
    indices at H/16. ``with_decoder=False`` leaves the decoder out, as the
    JAX ``OneDC`` tree holds it (flax creates a submodule's parameters only
    where it is called, and the distillation only encodes)."""

    def __init__(self, hidden: int = 128,
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, z_channels: int = 256,
                 num_embeddings: int = 1024, with_decoder: bool = True):
        super().__init__()
        self.encoder = VQGANEncoder(hidden, channel_mult, num_res_blocks,
                                    z_channels)
        if with_decoder:
            self.decoder = VQGANDecoder(hidden, channel_mult, num_res_blocks,
                                        z_channels)
        self.quantize = VectorQuantizer(num_embeddings, z_channels)

    def encode(self, x01) -> Tuple[torch.Tensor, torch.Tensor]:
        """[0, 1] image NCHW -> (quantized latents (B, h, w, D), indices
        (B, h, w))."""
        return self.quantize(self.encoder(x01).permute(0, 2, 3, 1))

    def decode(self, indices):
        """Indices (B, h, w) -> image NCHW in [0, 1]."""
        quant = self.quantize.get_codebook_entry(indices)
        return self.decoder(quant.permute(0, 3, 1, 2)).clamp(0.0, 1.0)

    def forward(self, x01):
        return self.encode(x01)

    def codebook(self) -> torch.Tensor:
        """The (K, D) codebook (the distillation's MSE targets)."""
        return self.quantize.embedding

    def autoencode(self, x01):
        return self.decode(self.encode(x01)[1])
