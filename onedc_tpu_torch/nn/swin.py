"""Swin-style window attention blocks, NHWC.

JAX counterpart: ``onedc_tpu/nn/swin.py`` (``_shift_masks`` :25,
``WindowAttention`` :48, ``SwinBlock`` :113, ``DualSwinBlock`` :138), the
Codeformer's plain + shifted window attention pairs with an optional
absolute per-window position embedding. As in the JAX package: the scores
in f32, the additive ``NEG_INF`` of -1e9 (not -inf), the shifted variant
as a roll by -ws/2 with masks on the last window row and column only, the
position embedding (ws², ws²), LayerNorm's eps flax's 1e-6 and exact-erf
GELU. A window that does not divide the grid raises ``ValueError`` (JAX
asserts). Stock torch ops: the JAX blocks are plain XLA, no Pallas.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .unet_sd import LAYER_NORM_EPS  # flax's default, 1e-6

NEG_INF = -1e9  # additive mask value, as the JAX package's


@functools.lru_cache(maxsize=None)
def _shift_masks(window_size: int, displacement: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(upper_lower, left_right) additive masks, each (w², w²): after the
    cyclic shift by -displacement, the last ``displacement`` rows (columns)
    of the window grid hold wrapped content that must not attend across
    the seam. Numpy, cached (read-only: never written in place)."""
    w, d = window_size, displacement
    ul = np.zeros((w * w, w * w), np.float32)
    ul[-d * w:, :-d * w] = NEG_INF
    ul[:-d * w, -d * w:] = NEG_INF
    lr = np.zeros((w, w, w, w), np.float32)
    lr[:, -d:, :, :-d] = NEG_INF
    lr[:, :-d, :, -d:] = NEG_INF
    return ul, lr.reshape(w * w, w * w)


def shift_mask(window_size: int, nh: int, nw: int, device) -> torch.Tensor:
    """(nh * nw, w², w²) f32: the upper-lower mask on the last window row,
    the left-right mask on the last window column (both on the corner), as
    JAX sums them."""
    ul, lr = _shift_masks(window_size, window_size // 2)
    win = np.arange(nh * nw)
    ul_sel = (win // nw == nh - 1).astype(np.float32)
    lr_sel = (win % nw == nw - 1).astype(np.float32)
    mask = ul_sel[:, None, None] * ul[None] + lr_sel[:, None, None] * lr[None]
    return torch.from_numpy(mask).to(device)


class WindowAttention(nn.Module):
    """Multi-head attention inside non-overlapping ws x ws windows; x (B,
    H, W, dim)."""

    def __init__(self, dim: int, heads: int, head_dim: int, window_size: int,
                 shifted: bool = False, use_pos_embedding: bool = False):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.window_size = window_size
        self.shifted = shifted
        inner = heads * head_dim
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Linear(inner, dim)
        if use_pos_embedding:
            # flax's normal(1.0) initialiser
            self.pos_embedding = nn.Parameter(
                torch.randn(window_size ** 2, window_size ** 2))

    def forward(self, x):
        b, h, w, _ = x.shape
        ws = self.window_size
        if h % ws or w % ws:
            raise ValueError(f"window {ws} does not divide the {h}x{w} grid "
                             f"(the JAX package asserts h % ws == 0 and "
                             f"w % ws == 0)")
        disp = ws // 2
        if self.shifted:
            x = torch.roll(x, (-disp, -disp), dims=(1, 2))
        nh, nw = h // ws, w // ws
        heads, hd = self.heads, self.head_dim

        def to_windows(t):  # (b, heads, windows, tokens, head_dim)
            t = t.reshape(b, nh, ws, nw, ws, heads, hd)
            return t.permute(0, 5, 1, 3, 2, 4, 6).reshape(
                b, heads, nh * nw, ws * ws, hd)

        q, k, v = (to_windows(t) for t in self.to_qkv(x).chunk(3, dim=-1))
        dots = torch.einsum("bhwid,bhwjd->bhwij", q.float(), k.float())
        dots = dots * hd ** -0.5
        if hasattr(self, "pos_embedding"):
            dots = dots + self.pos_embedding
        if self.shifted:
            dots = dots + shift_mask(ws, nh, nw, x.device)
        attn = dots.softmax(dim=-1).to(v.dtype)
        out = torch.einsum("bhwij,bhwjd->bhwid", attn, v)
        out = out.reshape(b, heads, nh, nw, ws, ws, hd)
        out = out.permute(0, 2, 4, 3, 5, 1, 6).reshape(b, h, w, heads * hd)
        out = self.to_out(out)
        if self.shifted:
            out = torch.roll(out, (disp, disp), dims=(1, 2))
        return out


class SwinBlock(nn.Module):
    """Pre-LN window attention + MLP, both residual."""

    def __init__(self, dim: int, heads: int, head_dim: int, mlp_dim: int,
                 window_size: int, shifted: bool = False,
                 use_pos_embedding: bool = False):
        super().__init__()
        self.norm_attn = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = WindowAttention(dim, heads, head_dim, window_size,
                                    shifted, use_pos_embedding)
        self.norm_mlp = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp_0 = nn.Linear(dim, mlp_dim)
        self.mlp_2 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        x = x + self.attn(self.norm_attn(x))
        return x + self.mlp_2(F.gelu(self.mlp_0(self.norm_mlp(x))))


class DualSwinBlock(nn.Module):
    """Plain + shifted window attention pair; the position embedding, if
    any, on the plain block only."""

    def __init__(self, dim: int, heads: int, head_dim: int, mlp_dim: int,
                 window_size: int, use_pos_embedding: bool = False):
        super().__init__()
        self.block_w = SwinBlock(dim, heads, head_dim, mlp_dim, window_size,
                                 shifted=False,
                                 use_pos_embedding=use_pos_embedding)
        self.block_sw = SwinBlock(dim, heads, head_dim, mlp_dim, window_size,
                                  shifted=True)

    def forward(self, x):
        return self.block_sw(self.block_w(x))
