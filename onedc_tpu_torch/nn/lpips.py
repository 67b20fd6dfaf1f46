"""LPIPS perceptual metric (VGG16 backbone), NCHW.

JAX counterpart: ``onedc_tpu/nn/lpips.py`` (``VGG16Features`` :44,
``LPIPS`` :69, ``make_lpips_fn`` :98, ``convert_torch_vgg16`` :106): the
reference's stage-I loss (piq LPIPS with ``replace_pooling=True``, an
avg-pool VGG, ``src/losses/pixel_loss.py:40``) and its eval metric.

Weights come from disk, in the JAX package's converted safetensors
layout, so one file drives both packages: flat "/" keys,
``features/conv{i}/{kernel,bias}`` (HWIO kernels, i in 0..12) and the
five linear heads ``lin{k}`` of shape (1, 1, C, 1) (the key the JAX
converter writes, without a ``/kernel``). ``lpips_state_dict`` maps such
a dict onto the module's state dict: kernels to OIHW, ``lin{k}`` kept as
they are (a (1, 1, C, 1) array reshapes to the (1, C, 1, 1) conv weight
without moving an element).

``make_lpips_fn`` returns a function of (B, H, W, 3) arrays or tensors in
[0, 1], as the JAX function takes them, on the card unless a device is
named; gradients flow through it to its inputs (the training loss).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.convert import flat_state_dict
from ..utils.device import resolve_device
from ..utils.numerics import pinned_numerics
from ..utils.safetensors import load_safetensors

# VGG16 conv plan: (out_ch, pool_before) for the 13 convs
_VGG16_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# feature taps after convs (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
_TAPS = (1, 3, 6, 9, 12)
# torchvision indices of the 13 convs inside ``features.*``
_TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
LIN_KEYS = tuple(f"lin{k}" for k in range(len(_TAPS)))

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class VGG16Features(nn.Module):
    """VGG16 conv trunk emitting the 5 LPIPS tap activations.

    ``avg_pool=True`` replicates piq's replace_pooling (the reference
    training loss); False is the standard max-pool VGG.
    """

    def __init__(self, avg_pool: bool = True):
        super().__init__()
        self.avg_pool = avg_pool
        cin = 3
        for i, (ch, _) in enumerate(_VGG16_PLAN):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch

    def pool(self, x):
        return F.avg_pool2d(x, 2) if self.avg_pool else F.max_pool2d(x, 2)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        taps = []
        for i, (_, pool_before) in enumerate(_VGG16_PLAN):
            if pool_before:
                x = self.pool(x)
            x = F.relu(getattr(self, f"conv{i}")(x))
            if i in _TAPS:
                taps.append(x)
        return tuple(taps)


def imagenet_normalize(x01: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> ImageNet-normalised."""
    mean = torch.from_numpy(_IMAGENET_MEAN).to(x01).view(1, 3, 1, 1)
    std = torch.from_numpy(_IMAGENET_STD).to(x01).view(1, 3, 1, 1)
    return (x01 - mean) / std


class LPIPS(nn.Module):
    """Full LPIPS head: normalize -> VGG taps -> unit-norm -> linear (its
    weights clamped at 0) -> spatial mean, summed over the taps."""

    def __init__(self, avg_pool: bool = True):
        super().__init__()
        self.features = VGG16Features(avg_pool)
        for key, tap in zip(LIN_KEYS, _TAPS):
            # the converted layout, (1, 1, C, 1): see the module docstring
            self.register_parameter(key, nn.Parameter(
                torch.ones(1, 1, _VGG16_PLAN[tap][0], 1)))

    def forward(self, x01, y01):
        """x01, y01: (B, 3, H, W) in [0, 1]. Returns (B,) distances."""
        b = x01.shape[0]
        # one pass over both images (the JAX module calls the trunk twice)
        feats = self.features(imagenet_normalize(torch.cat([x01, y01])))
        total = 0.0
        for key, f in zip(LIN_KEYS, feats):
            f = f / torch.sqrt((f * f).sum(1, keepdim=True) + 1e-10)
            d = (f[:b] - f[b:]) ** 2
            w = getattr(self, key).clamp(min=0.0).reshape(1, -1, 1, 1)
            total = total + F.conv2d(d, w).mean(dim=(1, 2, 3))
        return total


def lpips_state_dict(flat) -> Dict[str, torch.Tensor]:
    """The converted flat dict (``load_safetensors``, or the JAX package's
    ``flatten_params`` of its params) -> ``LPIPS``'s state dict."""
    return flat_state_dict(flat, as_is=LIN_KEYS)


def as_nchw(a, device: torch.device) -> torch.Tensor:
    """(B, H, W, C) array or tensor -> f32 (B, C, H, W) tensor on
    ``device`` (a permuted view of a tensor already there)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return a.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2)


def frozen_on(module: nn.Module, device) -> nn.Module:
    """``module`` on ``device`` (the card unless named), in eval mode,
    no parameter requiring grad; channels-last on the card."""
    module = module.to(resolve_device(device)).eval().requires_grad_(False)
    if next(module.parameters()).device.type == "cuda":
        module = module.to(memory_format=torch.channels_last)
    return module


def nhwc_metric(module: nn.Module) -> Callable:
    """fn(x01, y01) over (B, H, W, 3) arrays or tensors in [0, 1] -> (B,)
    tensor on the module's device, run under ``pinned_numerics``."""
    device = next(module.parameters()).device

    def fn(x01, y01):
        with pinned_numerics():
            return module(as_nchw(x01, device), as_nchw(y01, device))
    return fn


def load_lpips(weights_path, avg_pool: bool = True, device=None) -> LPIPS:
    """The LPIPS net of a converted file, frozen on ``device``."""
    model = LPIPS(avg_pool)
    model.load_state_dict(lpips_state_dict(load_safetensors(weights_path)),
                          strict=True)
    return frozen_on(model, device)


def make_lpips_fn(weights_path, avg_pool: bool = True,
                  device=None) -> Callable:
    """Load weights and return fn(x01, y01) -> (B,) distances."""
    return nhwc_metric(load_lpips(weights_path, avg_pool, device))


def convert_torch_vgg16(vgg_state: dict, lin_weights: Sequence[np.ndarray]):
    """torchvision VGG16 ``features.*`` state dict + 5 LPIPS lin layers ->
    the converted layout. Returns a flat {key: array} dict."""
    out = {}
    for i, ti in enumerate(_TORCHVISION_CONVS):
        w = np.asarray(vgg_state[f"features.{ti}.weight"])  # OIHW
        b = np.asarray(vgg_state[f"features.{ti}.bias"])
        out[f"features/conv{i}/kernel"] = w.transpose(2, 3, 1, 0)
        out[f"features/conv{i}/bias"] = b
    for k, lin in enumerate(lin_weights):
        lin = np.asarray(lin)  # (1, C, 1, 1) torch conv weight
        out[f"lin{k}"] = lin.transpose(2, 3, 1, 0)
    return out


def random_vgg16_state(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A torchvision VGG16 ``features.*`` state dict of seeded random f32
    weights: kernels He-normal (N(0, 2 / fan_in), so the activations keep
    their scale through the ReLU stack), biases N(0, 0.01^2)."""
    state = {}
    cin = 3
    for ti, (ch, _) in zip(_TORCHVISION_CONVS, _VGG16_PLAN):
        state[f"features.{ti}.weight"] = (
            rng.standard_normal((ch, cin, 3, 3)) * np.sqrt(2.0 / (cin * 9))
        ).astype(np.float32)
        state[f"features.{ti}.bias"] = (
            0.01 * rng.standard_normal(ch)).astype(np.float32)
        cin = ch
    return state


def random_lpips_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded random weights in the converted layout, through
    ``convert_torch_vgg16`` (fixtures: no pretrained file is at hand).
    The heads draw from U(-0.1, 0.5), so some entries are clamped."""
    rng = np.random.default_rng(seed)
    vgg = random_vgg16_state(rng)
    lins = [rng.uniform(-0.1, 0.5, (1, _VGG16_PLAN[t][0], 1, 1)).astype(
        np.float32) for t in _TAPS]
    return convert_torch_vgg16(vgg, lins)
