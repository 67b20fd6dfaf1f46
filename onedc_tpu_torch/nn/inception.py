"""InceptionV3 feature extractor (FID variant), NCHW.

JAX counterpart: ``onedc_tpu/nn/inception.py`` (``avg_pool_exclude_pad``
:34, ``max_pool`` :50, ``BasicConv`` :56, ``InceptionA``-``E``,
``InceptionV3`` :159, ``make_inception_fn`` :202,
``convert_torch_inception`` :236): the feature network behind the
reference's FID / KID / IS (torch-fidelity's "FID Inception": torchvision
InceptionV3 with pytorch-fid's exclude-padding average pools and a
max-pool branch in the last mixed block).

- BatchNorm is folded into the conv weights at conversion time (in f64).
- Input is uint8-range RGB; the network resizes to 299x299 bilinearly
  with ``align_corners=False`` and no antialiasing, for up- and for
  downscaling (``jax.image.resize(..., "bilinear", antialias=False)`` in
  the JAX package), and scales to [-1, 1].
- ``pool3`` (2048-d global-average features) feeds FID / KID; ``logits``
  (1008-way, the original TF class layout) feed the Inception Score.

Weights come from disk in the JAX package's converted layout (module
paths as the flax names, ``<block>/conv/{kernel,bias}``, ``fc/{kernel,
bias}``); ``inception_state_dict`` maps it onto the module.
``random_inception_weights`` draws seeded numpy weights through the
converter (the JAX version uses flax's init).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.convert import flat_state_dict
from ..utils.numerics import pinned_numerics
from ..utils.safetensors import load_safetensors
from .lpips import frozen_on


def avg_pool_exclude_pad(x, window: int = 3, stride: int = 1, pad: int = 1):
    """Average pool whose divisor counts only in-bounds elements (the
    pytorch-fid InceptionA/C/E quirk)."""
    return F.avg_pool2d(x, window, stride, pad, count_include_pad=False)


def max_pool(x, window: int = 3, stride: int = 2, pad: int = 0):
    return F.max_pool2d(x, window, stride, pad)


class BasicConv(nn.Module):
    """Conv + bias (BN pre-folded) + ReLU."""

    def __init__(self, cin: int, out_ch: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, out_ch, kernel, stride, padding)

    def forward(self, x):
        return F.relu(self.conv(x))


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, (1, 1))
        self.branch5x5_1 = BasicConv(cin, 48, (1, 1))
        self.branch5x5_2 = BasicConv(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv(cin, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_exclude_pad(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv(96, 96, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, ch7: int):
        super().__init__()
        c = ch7
        self.branch1x1 = BasicConv(cin, 192, (1, 1))
        self.branch7x7_1 = BasicConv(cin, c, (1, 1))
        self.branch7x7_2 = BasicConv(c, c, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c, (1, 1))
        self.branch7x7dbl_2 = BasicConv(c, c, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c, c, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c, c, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_exclude_pad(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, (1, 1))
        self.branch3x3_2 = BasicConv(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, max_pool(x)], 1)


class InceptionE(nn.Module):
    """``pool="avg"`` for Mixed_7b (FIDInceptionE_1), ``"max"`` for
    Mixed_7c (FIDInceptionE_2 replaces the average pool with max)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv(cin, 320, (1, 1))
        self.branch3x3_1 = BasicConv(cin, 384, (1, 1))
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (avg_pool_exclude_pad(x) if self.pool == "avg"
              else max_pool(x, 3, 1, 1))
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """FID-variant InceptionV3. Input: (B, 3, H, W) float in [0, 255]."""

    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x255):
        """Returns (pool3 (B, 2048), logits (B, num_classes))."""
        x = x255.float() / 255.0
        if x.shape[2] != 299 or x.shape[3] != 299:
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False, antialias=False)
        x = (x - 0.5) * 2.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool3 = x.mean(dim=(2, 3))
        return pool3, self.fc(pool3)


def inception_state_dict(flat) -> Dict[str, torch.Tensor]:
    """The converted flat dict (``load_safetensors``, or the JAX package's
    ``flatten_params`` of its params) -> ``InceptionV3``'s state dict."""
    return flat_state_dict(flat)


def make_inception_fn(weights_path, batch: int = 32,
                      device=None) -> Callable[[np.ndarray], dict]:
    """Load converted weights; return fn(uint8-range patches, (N, H, W, 3)
    numpy) -> {'features': (N, 2048), 'logits': (N, num_classes)} numpy,
    run ``batch`` patches at a time on ``device`` (the card unless named).
    No padding to a fixed batch: torch compiles nothing per shape."""
    state = inception_state_dict(load_safetensors(weights_path))
    model = InceptionV3(num_classes=state["fc.weight"].shape[0])
    model.load_state_dict(state, strict=True)
    model = frozen_on(model, device)
    device = next(model.parameters()).device

    def fn(patches: np.ndarray) -> dict:
        patches = np.asarray(patches, np.float32)
        feats, logits = [], []
        with torch.no_grad(), pinned_numerics():
            for i in range(0, len(patches), batch):
                chunk = torch.from_numpy(patches[i:i + batch]).to(device)
                f, lg = model(chunk.permute(0, 3, 1, 2))
                feats.append(f.cpu().numpy())
                logits.append(lg.cpu().numpy())
        return {"features": np.concatenate(feats),
                "logits": np.concatenate(logits)}

    return fn


def convert_torch_inception(state: dict, bn_eps: float = 1e-3) -> dict:
    """pytorch-fid ``pt_inception-2015-12-05`` (or torchvision
    inception_v3) state dict -> flat {key: np.ndarray} in the converted
    layout, with BatchNorm folded into each conv (in f64).

    torch keys: ``<block>.conv.weight`` (OIHW, no bias) +
    ``<block>.bn.{weight,bias,running_mean,running_var}``; ``fc.weight``
    (out,in) + ``fc.bias``.
    """
    out = {}
    convs = sorted({k[:-len(".conv.weight")] for k in state
                    if k.endswith(".conv.weight")})
    for name in convs:
        w = np.asarray(state[f"{name}.conv.weight"], np.float64)  # OIHW
        gamma = np.asarray(state[f"{name}.bn.weight"], np.float64)
        beta = np.asarray(state[f"{name}.bn.bias"], np.float64)
        mean = np.asarray(state[f"{name}.bn.running_mean"], np.float64)
        var = np.asarray(state[f"{name}.bn.running_var"], np.float64)
        scale = gamma / np.sqrt(var + bn_eps)
        w = w * scale[:, None, None, None]
        b = beta - mean * scale
        key = name.replace(".", "/")
        out[f"{key}/conv/kernel"] = w.transpose(2, 3, 1, 0).astype(np.float32)
        out[f"{key}/conv/bias"] = b.astype(np.float32)
    out["fc/kernel"] = np.asarray(state["fc.weight"]).T.astype(np.float32)
    out["fc/bias"] = np.asarray(state["fc.bias"]).astype(np.float32)
    return out


def random_torch_inception(seed: int = 0, num_classes: int = 8
                           ) -> Dict[str, np.ndarray]:
    """A pytorch-fid layout state dict (unfolded conv + BN) of seeded
    random f32 weights: kernels He-normal, BN scale U(0.5, 1.5), shift
    N(0, 0.1^2), running mean N(0, 0.1^2), running variance U(0.5, 2);
    the fc N(0, 1 / 2048)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        model = InceptionV3(num_classes)
    state = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, BasicConv):
            continue
        o, i, kh, kw = mod.conv.weight.shape
        state[f"{name}.conv.weight"] = (rng.standard_normal((o, i, kh, kw))
                                        * np.sqrt(2.0 / (i * kh * kw)))
        state[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, o)
        state[f"{name}.bn.bias"] = 0.1 * rng.standard_normal(o)
        state[f"{name}.bn.running_mean"] = 0.1 * rng.standard_normal(o)
        state[f"{name}.bn.running_var"] = rng.uniform(0.5, 2.0, o)
    state["fc.weight"] = rng.standard_normal((num_classes, 2048)) / np.sqrt(
        2048)
    state["fc.bias"] = np.zeros(num_classes)
    return {k: v.astype(np.float32) for k, v in state.items()}


def random_inception_weights(seed: int = 0, num_classes: int = 8) -> dict:
    """Seeded random weights in the converted layout (fixtures, where no
    pretrained file is at hand): ``random_torch_inception`` folded by
    ``convert_torch_inception``."""
    return convert_torch_inception(random_torch_inception(seed,
                                                          num_classes))
