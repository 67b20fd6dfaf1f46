"""DISTS (Deep Image Structure and Texture Similarity), NCHW.

JAX counterpart: ``onedc_tpu/nn/dists.py`` (``l2_pool`` :33,
``_DISTSTrunk`` :49, ``DISTS`` :68, ``make_dists_fn`` :119,
``convert_torch_dists`` :127), the reference's eval-side DISTS
(``src/test_quality.py:10,238``, the DISTS_pytorch package): a VGG16
trunk whose pools are L2 pools (hanning-windowed RMS downsampling), with
per-channel texture (alpha) and structure (beta) weights over six stages
(the raw image + relu1_2, relu2_2, relu3_3, relu4_3, relu5_3).

Weights come from disk in the JAX package's converted layout
(``features/conv{i}/{kernel,bias}``, ``alpha`` and ``beta`` of shape
(1, 1475)); ``dists_state_dict`` maps it onto the module.
``random_dists_weights`` draws seeded numpy weights in that layout (the
JAX version uses flax's init, which the card's machine cannot run).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.convert import flat_state_dict
from ..utils.safetensors import load_safetensors
from .lpips import (
    VGG16Features,
    convert_torch_vgg16,
    frozen_on,
    imagenet_normalize,
    nhwc_metric,
    random_vgg16_state,
)

# channels of the six DISTS stages (input image + 5 VGG taps)
DISTS_CHNS = (3, 64, 128, 256, 512, 512)


def l2_pool(x, window: int = 3, stride: int = 2):
    """Hanning-windowed RMS downsample of (B, C, H, W) (DISTS L2pooling:
    hanning(5)[1:-1] outer product, normalized; conv stride 2 pad 1 per
    channel; sqrt(out + 1e-12))."""
    a = np.hanning(window + 2)[1:-1]
    g = np.outer(a, a)
    g = (g / g.sum()).astype(np.float32)
    c = x.shape[1]
    k = torch.from_numpy(g).to(x).expand(c, 1, window, window)
    out = F.conv2d(x * x, k, stride=stride, padding=1, groups=c)
    return torch.sqrt(out + 1e-12)


class _DISTSTrunk(VGG16Features):
    """Raw image + 5 VGG taps with L2 pooling between stages."""

    def pool(self, x):
        return l2_pool(x)

    def forward(self, img01):
        return [img01] + list(super().forward(imagenet_normalize(img01)))


class DISTS(nn.Module):
    """(x01, y01) -> (B,) DISTS distance, inputs (B, 3, H, W) in [0, 1]."""

    def __init__(self, c1: float = 1e-6, c2: float = 1e-6):
        super().__init__()
        self.c1 = c1
        self.c2 = c2
        self.features = _DISTSTrunk()
        total_c = sum(DISTS_CHNS)
        self.alpha = nn.Parameter(torch.zeros(1, total_c))
        self.beta = nn.Parameter(torch.zeros(1, total_c))

    def forward(self, x01, y01):
        b = x01.shape[0]
        # one trunk, one pass over both images
        feats = self.features(torch.cat([x01, y01]))
        w_sum = self.alpha.sum() + self.beta.sum()
        a_split = torch.split(self.alpha[0], DISTS_CHNS)
        b_split = torch.split(self.beta[0], DISTS_CHNS)
        dist1 = 0.0
        dist2 = 0.0
        for k, f in enumerate(feats):
            a, bb = f[:b], f[b:]
            x_mean = a.mean(dim=(2, 3), keepdim=True)
            y_mean = bb.mean(dim=(2, 3), keepdim=True)
            s1 = ((2 * x_mean * y_mean + self.c1)
                  / (x_mean ** 2 + y_mean ** 2 + self.c1))
            x_var = ((a - x_mean) ** 2).mean(dim=(2, 3), keepdim=True)
            y_var = ((bb - y_mean) ** 2).mean(dim=(2, 3), keepdim=True)
            xy_cov = ((a * bb).mean(dim=(2, 3), keepdim=True)
                      - x_mean * y_mean)
            s2 = (2 * xy_cov + self.c2) / (x_var + y_var + self.c2)
            dist1 = dist1 + (a_split[k][None] * s1[:, :, 0, 0]).sum(-1)
            dist2 = dist2 + (b_split[k][None] * s2[:, :, 0, 0]).sum(-1)
        return 1.0 - (dist1 + dist2) / w_sum


def dists_state_dict(flat) -> Dict[str, torch.Tensor]:
    """The converted flat dict (``load_safetensors``, or the JAX package's
    ``flatten_params`` of its params) -> ``DISTS``'s state dict."""
    return flat_state_dict(flat, as_is=("alpha", "beta"))


def make_dists_fn(weights_path, device=None) -> Callable:
    """Load converted weights; return fn(x01, y01) -> (B,) over (B, H, W,
    3) arrays or tensors, on ``device`` (the card unless named)."""
    model = DISTS()
    model.load_state_dict(dists_state_dict(load_safetensors(weights_path)),
                          strict=True)
    return nhwc_metric(frozen_on(model, device))


def convert_torch_dists(vgg_state: dict, alpha: np.ndarray,
                        beta: np.ndarray) -> dict:
    """torchvision VGG16 ``features.*`` state dict + the DISTS package's
    alpha/beta buffers (each (1, 1472, 1, 1) excluding the image stage, or
    (1, 1475, 1, 1) including it) -> the converted flat layout."""
    out = dict(convert_torch_vgg16(vgg_state, []))
    alpha = np.asarray(alpha, np.float32).reshape(1, -1)
    beta = np.asarray(beta, np.float32).reshape(1, -1)
    total = sum(DISTS_CHNS)
    if alpha.shape[1] == total - 3:  # package stores stages 1..5 only
        pad = np.zeros((1, 3), np.float32)
        alpha = np.concatenate([pad, alpha], axis=1)
        beta = np.concatenate([pad, beta], axis=1)
    if alpha.shape[1] != total or beta.shape != alpha.shape:
        raise ValueError(f"DISTS alpha {alpha.shape} / beta {beta.shape}: "
                         f"expected {total - 3} or {total} channels")
    out["alpha"] = alpha
    out["beta"] = beta
    return out


def random_dists_weights(seed: int = 0) -> dict:
    """Seeded random weights in the converted layout, through
    ``convert_torch_dists``: a He-normal VGG16 and alpha / beta from
    U(0.01, 1) over all six stages (positive, as trained weights are, so
    the normaliser stays away from 0)."""
    rng = np.random.default_rng(seed)
    vgg = random_vgg16_state(rng)
    alpha, beta = (rng.uniform(0.01, 1.0, (1, sum(DISTS_CHNS), 1, 1))
                   .astype(np.float32) for _ in range(2))
    return convert_torch_dists(vgg, alpha, beta)
