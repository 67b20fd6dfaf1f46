"""Image quality metrics: PSNR and (MS-)SSIM on tensors, the patch-FID /
KID / IS statistics in numpy.

JAX counterpart: ``onedc_tpu/eval/metrics.py`` (``psnr`` :28, ``ssim`` /
``ms_ssim`` :80 / :87, ``extract_patches`` :113, ``frechet_distance``
:129, ``polynomial_kid`` :139, ``FeatureStats`` :160, ``inception_score``
:186, ``to_uint8_range`` :211, ``compute_patch_fid`` :217), the
measurement stack of the reference's ``src/test_quality.py``.

The tensor metrics take (B, H, W, C) tensors in [0, data_range], as the
JAX functions take their arrays, on whatever device the tensors are on:
the separable Gaussian blur is a depthwise ``conv2d`` in valid padding,
the scales of MS-SSIM 2x2 average pools. The numpy code is the port's own
copy of the JAX package's, line for line, so the statistics agree bit
for bit on the same features.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def psnr(x, y, data_range: float = 1.0):
    """x, y: (..., H, W, C) in [0, data_range]. Returns per-image PSNR."""
    mse = ((x - y) ** 2).mean(dim=(-3, -2, -1))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=1e-12))


# ---------------------------------------------------------------------------
# (MS-)SSIM: standard 11x11 gaussian window, K1=0.01 K2=0.03
# ---------------------------------------------------------------------------

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _fgauss(window_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(window_size, dtype=np.float64) - (window_size - 1) / 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x, win: np.ndarray):
    """Separable gaussian filter over H, W of NCHW (valid padding): along
    H, then along W, one depthwise conv each."""
    c = x.shape[1]
    k = torch.from_numpy(win).to(x)
    x = F.conv2d(x, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def _ssim_per_channel(x, y, win, data_range: float):
    """x, y NCHW -> (SSIM, CS) per image."""
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _blur(x, win)
    mu_y = _blur(y, win)
    sigma_x = _blur(x * x, win) - mu_x ** 2
    sigma_y = _blur(y * y, win) - mu_y ** 2
    sigma_xy = _blur(x * y, win) - mu_x * mu_y

    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def ssim(x, y, data_range: float = 1.0, window_size: int = 11,
         sigma: float = 1.5):
    win = _fgauss(window_size, sigma)
    s, _ = _ssim_per_channel(_nchw(x), _nchw(y), win, data_range)
    return s


def ms_ssim(x, y, data_range: float = 1.0, window_size: int = 11,
            sigma: float = 1.5,
            weights: Sequence[float] = _MSSSIM_WEIGHTS):
    """Multi-scale SSIM over 5 dyadic scales (needs min side >= 176)."""
    win = _fgauss(window_size, sigma)
    levels = len(weights)
    x, y = _nchw(x), _nchw(y)
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)

    mcs = []
    for i in range(levels):
        s, cs = _ssim_per_channel(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(cs.clamp(min=0.0))
            x = F.avg_pool2d(x, 2)
            y = F.avg_pool2d(y, 2)
    s = s.clamp(min=0.0)
    stack = torch.stack(mcs + [s], dim=0)  # (levels, B)
    return torch.prod(stack ** w[:, None], dim=0)


# ---------------------------------------------------------------------------
# Patch extraction for the FID/256 protocol (ref test_quality.py:54-162)
# ---------------------------------------------------------------------------

def extract_patches(img: np.ndarray, patch: int = 256,
                    shifted: bool = False) -> List[np.ndarray]:
    """Non-overlapping patches; `shifted` starts at patch/2 in both axes.

    Mirrors the Mentzer FID/256 two-pass protocol: pass 1 tiles from (0,0),
    pass 2 from (128,128). Images smaller than the patch are skipped.
    """
    h, w = img.shape[:2]
    off = patch // 2 if shifted else 0
    out = []
    for top in range(off, h - patch + 1, patch):
        for left in range(off, w - patch + 1, patch):
            out.append(img[top:top + patch, left:left + patch])
    return out


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """FID between two gaussians (numpy, float64)."""
    from scipy import linalg
    diff = mu1 - mu2
    covmean = linalg.sqrtm(cov1 @ cov2)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1 + cov2 - 2.0 * covmean))


def polynomial_kid(feats_x: np.ndarray, feats_y: np.ndarray,
                   subset_size: int = 1000, n_subsets: int = 100,
                   seed: int = 0) -> Tuple[float, float]:
    """Kernel Inception Distance with the standard cubic kernel."""
    rng = np.random.default_rng(seed)
    d = feats_x.shape[1]
    m = min(subset_size, len(feats_x), len(feats_y))
    vals = []
    for _ in range(n_subsets):
        fx = feats_x[rng.choice(len(feats_x), m, replace=False)]
        fy = feats_y[rng.choice(len(feats_y), m, replace=False)]
        kxx = (fx @ fx.T / d + 1) ** 3
        kyy = (fy @ fy.T / d + 1) ** 3
        kxy = (fx @ fy.T / d + 1) ** 3
        term = ((kxx.sum() - np.trace(kxx)) / (m * (m - 1))
                + (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
                - 2 * kxy.mean())
        vals.append(term)
    return float(np.mean(vals)), float(np.std(vals))


class FeatureStats:
    """Streaming mean/cov accumulator for FID."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.outer = np.zeros((dim, dim), np.float64)
        self.feats: List[np.ndarray] = []

    def update(self, feats: np.ndarray, keep: bool = True):
        feats = np.asarray(feats, np.float64)
        self.n += len(feats)
        self.sum += feats.sum(0)
        self.outer += feats.T @ feats
        if keep:
            self.feats.append(feats.astype(np.float32))

    def mean_cov(self):
        mu = self.sum / self.n
        cov = self.outer / (self.n - 1) - np.outer(mu, mu) * self.n / (self.n - 1)
        return mu, cov

    def all_feats(self) -> np.ndarray:
        return np.concatenate(self.feats, 0)


def inception_score(logits: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """Standard IS over class logits: exp(mean_split KL(p(y|x) || p(y))).

    torchmetrics' InceptionScore protocol (ref test_quality.py:14,
    265-268): split the sample set, per split compute
    mean_x KL(p(y|x)||mean_x p(y|x)), report mean/std of exp(KL).
    """
    logits = np.asarray(logits, np.float64)
    logp = logits - logits.max(axis=1, keepdims=True)
    p = np.exp(logp)
    p /= p.sum(axis=1, keepdims=True)
    # torchmetrics randomly permutes features before splitting; patches
    # arrive grouped per image here, so an in-order split would correlate
    # the splits. Fixed seed keeps the metric deterministic.
    p = p[np.random.default_rng(42).permutation(len(p))]
    n = len(p)
    scores = []
    for part in np.array_split(p, min(splits, n)):
        marginal = part.mean(axis=0, keepdims=True)
        kl = np.sum(part * (np.log(part + 1e-16)
                            - np.log(marginal + 1e-16)), axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def to_uint8_range(img01: np.ndarray) -> np.ndarray:
    """[0,1] float image -> rounded 0..255 floats (the reference's
    image_to_255_scale, test_quality.py:27-50)."""
    return np.round(np.clip(img01, 0.0, 1.0) * 255.0)


def compute_patch_fid(real_imgs, fake_imgs,
                      feature_fn: Callable[[np.ndarray], dict],
                      patch: int = 256) -> dict:
    """Full patch-FID/KID/IS over two image iterables ([-1,1] HWC arrays).

    ``feature_fn`` maps a batch of uint8-range (0..255) patches to
    ``{"features": (N,D), "logits": (N,K)}`` (InceptionV3 pool3 + class
    logits; see ``nn/inception.py``). IS is computed over the fake patches
    only, matching the reference protocol
    (test_quality.py:119-120,158-159).
    """
    stats = {}
    fake_logits: List[np.ndarray] = []
    for name, imgs in (("real", real_imgs), ("fake", fake_imgs)):
        st = None
        for img in imgs:
            patches = (extract_patches(img, patch, False)
                       + extract_patches(img, patch, True))
            if not patches:
                continue
            out = feature_fn(to_uint8_range(
                np.stack(patches) * 0.5 + 0.5))
            feats = out["features"] if isinstance(out, dict) else out
            if st is None:
                st = FeatureStats(feats.shape[1])
            st.update(feats)
            if name == "fake" and isinstance(out, dict) \
                    and "logits" in out:
                fake_logits.append(np.asarray(out["logits"]))
        stats[name] = st
    mu_r, cov_r = stats["real"].mean_cov()
    mu_f, cov_f = stats["fake"].mean_cov()
    fid = frechet_distance(mu_r, cov_r, mu_f, cov_f)
    kid_mean, kid_std = polynomial_kid(stats["real"].all_feats(),
                                       stats["fake"].all_feats())
    res = {"fid": fid, "kid_mean": kid_mean, "kid_std": kid_std,
           "n_real": stats["real"].n, "n_fake": stats["fake"].n}
    if fake_logits:
        is_mean, is_std = inception_score(np.concatenate(fake_logits))
        res["inception_mean"] = is_mean
        res["inception_std"] = is_std
    return res
