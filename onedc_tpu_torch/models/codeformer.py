"""Codeformer: the stage-I semantic-distillation head.

JAX counterpart: ``onedc_tpu/models/codeformer.py`` (``Codeformer`` :20,
``AuxDecoder`` :59, ``codeformer_losses`` :79). It predicts MaskGIT-VQGAN
code logits from the hyperprior's semantic feature: y_semantic upsampled
x2 (``DepthConvBlock4``, a 1x1 expand to 4x channels, PixelShuffle in
torch's channel order, which is the JAX ``pixel_shuffle``'s, a second
``DepthConvBlock4``), three ``DualSwinBlock``s (the first with the
position embedding), and a conv-MLP head (GroupNorm(16, 1e-5) and
exact-erf GELU) to 1024-way logits. It is trained with CE against the
frozen VQGAN's indices and MSE of ``probs @ codebook`` against its
quantized latents.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import AttnBlockVQ, DepthConvBlock4, GroupNorm, \
    ResnetBlockVQ, conv1x1, conv3x3
from ..nn.swin import DualSwinBlock


class Codeformer(nn.Module):
    def __init__(self, in_ch: int = 768, codebook_size: int = 1024,
                 window_size: int = 16, head_dim: int = 64):
        super().__init__()
        c = in_ch
        heads = c // head_dim
        self.up_block0 = DepthConvBlock4(c, c)
        self.up_expand = conv1x1(c, c * 4)
        self.up_block1 = DepthConvBlock4(c, c)
        for i in range(3):
            self.add_module(f"swin{i}", DualSwinBlock(
                c, heads, head_dim, c * 4, window_size,
                use_pos_embedding=i == 0))
        self.head_0 = conv1x1(c, c * 4)
        self.head_norm0 = GroupNorm(c * 4, 16, 1e-5)
        self.head_3 = conv1x1(c * 4, c)
        self.head_norm1 = GroupNorm(c, 16, 1e-5)
        self.head_out = conv1x1(c, codebook_size)

    def forward(self, y_semantic) -> Tuple[torch.Tensor, torch.Tensor]:
        """y_semantic (B, C, h, w) -> (logits, probs), each (B, 2h, 2w, K)
        NHWC."""
        h = self.up_block0(y_semantic)
        h = self.up_block1(F.pixel_shuffle(self.up_expand(h), 2))
        h = h.permute(0, 2, 3, 1)
        for i in range(3):
            h = getattr(self, f"swin{i}")(h)
        h = h.permute(0, 3, 1, 2)
        h = F.gelu(self.head_norm0(self.head_0(h)))
        h = F.gelu(self.head_norm1(self.head_3(h)))
        logits = self.head_out(h).permute(0, 2, 3, 1)
        return logits, logits.softmax(dim=-1)


class AuxDecoder(nn.Module):
    """The reference's auxiliary latent decoder head, unused by any shipped
    flow; kept for parity, as the JAX package keeps it."""

    def __init__(self, in_ch: int = 256, out_ch: int = 4):
        super().__init__()
        self.res0 = ResnetBlockVQ(in_ch)
        self.res1 = ResnetBlockVQ(in_ch)
        self.attn0 = AttnBlockVQ(in_ch)
        self.res2 = ResnetBlockVQ(in_ch)
        self.conv_out = conv3x3(in_ch, out_ch)

    def forward(self, x):
        x = self.attn0(self.res1(self.res0(x)))
        return self.conv_out(self.res2(x))


def codeformer_losses(logits, probs, target_indices, target_quant,
                      codebook) -> Tuple[torch.Tensor, torch.Tensor]:
    """(CE, MSE) of the distillation. logits / probs (B, h, w, K),
    target_indices (B, h, w) int, target_quant (B, h, w, D), codebook (K,
    D). CE against one-hot targets, as the JAX package writes it."""
    logp = logits.log_softmax(dim=-1)
    onehot = F.one_hot(target_indices.long(), logits.shape[-1]).to(
        logits.dtype)
    ce = -(onehot * logp).sum(-1).mean()
    pred_quant = torch.einsum("bhwk,kd->bhwd", probs, codebook)
    mse = ((pred_quant - target_quant) ** 2).mean()
    return ce, mse
