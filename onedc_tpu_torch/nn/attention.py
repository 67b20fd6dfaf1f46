"""Attention dispatch: plain matmul + softmax for short sequences, the
hand-written flash kernel (K1) for long ones on the card.

JAX counterpart: ``onedc_tpu/nn/attention.py``. The routing rule is the
JAX package's ``can_flash`` (:78): both sequences at least 2048 tokens and
multiples of 128. The JAX package sends those to the Pallas TPU kernel and
everything else to XLA; here they go to K1's operator
(``ops/flash_attention.py``), which launches the kernel when the tensors
lie on the card and computes the plain version otherwise. The rule looks
at shapes alone, so an exported program keeps the operator. The
widest head the rule sees is the VAE mid-block's single 512-wide head,
which reaches it when the /8 grid is not a multiple of the 16-pixel window
(a 512x704 image: 64x88, 5632 tokens); K1 takes it in bf16.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import attention_plain, flash_attention

FLASH_MIN_SEQ = 2048
_LANE = 128


def can_flash(n: int, m: int) -> bool:
    return n % _LANE == 0 and m % _LANE == 0 and min(n, m) >= FLASH_MIN_SEQ


def einsum_attention(q, k, v, scale: float):
    """q (B,H,N,D), k/v (B,H,M,D) -> (B,H,N,D); f32 scores and softmax,
    probabilities cast to v's dtype (JAX ``einsum_attention`` :35)."""
    attn = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    attn = attn.softmax(dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


def multi_head_attention_bnhd(q, k, v, scale: Optional[float] = None):
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if can_flash(q.shape[1], k.shape[1]):
        return flash_attention(q, k, v, scale)
    return attention_plain(q, k, v, scale)


def multi_head_attention(q, k, v, scale: Optional[float] = None):
    """(B, H, N, D) x (B, H, M, D) -> (B, H, N, D)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if can_flash(q.shape[2], k.shape[2]):
        out = flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), scale)
        return out.transpose(1, 2)
    return einsum_attention(q, k, v, scale)
