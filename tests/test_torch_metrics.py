"""The port's image metrics (``onedc_tpu_torch/eval/metrics.py``) against
the JAX package's (``onedc_tpu/eval/metrics.py``) on seeded numpy inputs,
on the CPU: PSNR and (MS-)SSIM in f32 within a stated tolerance, and the
numpy statistics of the patch-FID protocol bit for bit."""

import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401  (a fixture)

import jax
from onedc_tpu.eval import metrics as jm
from onedc_tpu_torch.eval import metrics as pm

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# PSNR in dB; (MS-)SSIM in f32: the blurs sum 11 taps twice in another
# order than XLA's convolutions, and MS-SSIM's product of five powers
# carries each scale's rounding
PSNR_TOL = 1e-4
SSIM_ATOL, SSIM_RTOL = 1e-5, 1e-4


def _pair(h, w, seed):
    """(x, y), (2, h, w, 3) f32 in [0, 1]: a smooth image and a noisy,
    clipped copy, so (MS-)SSIM is away from both 0 and 1."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (2, h // 16, w // 16, 3))
    x = np.repeat(np.repeat(coarse, 16, 1), 16, 2)
    x = 0.7 * x + 0.3 * rng.uniform(0, 1, x.shape)
    y = np.clip(x + 0.08 * rng.standard_normal(x.shape), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("h,w", [(192, 192), (256, 320)])
def test_psnr_and_ssim_match_the_jax_package(h, w):
    x, y = _pair(h, w, h + w)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(pm.psnr(xt, yt).numpy(),
                               np.asarray(jax.jit(jm.psnr)(x, y)),
                               rtol=0, atol=PSNR_TOL)
    for name in ("ssim", "ms_ssim"):
        ref = np.asarray(jax.jit(getattr(jm, name))(x, y))
        got = getattr(pm, name)(xt, yt).numpy()
        assert got.shape == (2,) and np.all((0.05 < ref) & (ref < 0.99))
        np.testing.assert_allclose(got, ref, rtol=SSIM_RTOL, atol=SSIM_ATOL,
                                   err_msg=name)
    # identical images: SSIM and MS-SSIM are 1 (to f32 rounding)
    np.testing.assert_allclose(pm.ms_ssim(xt, xt).numpy(), 1.0, atol=1e-5)


def test_numpy_statistics_are_the_jax_packages_bit_for_bit():
    """FeatureStats, FID, KID, IS, the patch grid and the uint8 scaling on
    the same inputs give the same bits in both packages."""
    rng = np.random.default_rng(3)
    feats_r = rng.standard_normal((45, 24)).astype(np.float32)
    feats_f = (0.8 * rng.standard_normal((38, 24)) + 0.3).astype(np.float32)

    stats = []
    for mod in (jm, pm):
        st = mod.FeatureStats(24)
        for i in range(0, 45, 16):
            st.update(feats_r[i:i + 16])
        stats.append(st)
    (mu_j, cov_j), (mu_p, cov_p) = stats[0].mean_cov(), stats[1].mean_cov()
    assert np.array_equal(mu_j, mu_p) and np.array_equal(cov_j, cov_p)
    assert np.array_equal(stats[0].all_feats(), stats[1].all_feats())
    mu2, cov2 = np.mean(feats_f, 0, dtype=np.float64), np.cov(feats_f.T)
    assert jm.frechet_distance(mu_j, cov_j, mu2, cov2) == \
        pm.frechet_distance(mu_p, cov_p, mu2, cov2)
    for kw in ({}, {"subset_size": 20, "n_subsets": 7, "seed": 5}):
        assert jm.polynomial_kid(feats_r, feats_f, **kw) == \
            pm.polynomial_kid(feats_r, feats_f, **kw)
    logits = 3 * rng.standard_normal((37, 11))
    for splits in (10, 3, 1):
        assert jm.inception_score(logits, splits) == \
            pm.inception_score(logits, splits)

    img = rng.uniform(-1, 1, (200, 330, 3)).astype(np.float32)
    for patch in (64, 96, 256):
        for shifted in (False, True):
            a = jm.extract_patches(img, patch, shifted)
            b = pm.extract_patches(img, patch, shifted)
            assert len(a) == len(b)
            assert all(np.array_equal(p, q) for p, q in zip(a, b))
    x = rng.uniform(-0.2, 1.2, (50, 3))
    assert np.array_equal(jm.to_uint8_range(x), pm.to_uint8_range(x))


def _features(patches):
    """A numpy feature extractor for the protocol test: a fixed random
    projection of the patch means and variances, and logits of it."""
    p = np.asarray(patches, np.float64) / 255.0
    v = np.concatenate([p.mean((1, 2)), p.var((1, 2)),
                        p[:, ::8, ::8].reshape(len(p), -1)[:, :10]], 1)
    proj = np.random.default_rng(11).standard_normal((v.shape[1], 12))
    f = np.tanh(v @ proj)
    return {"features": f.astype(np.float32),
            "logits": (f @ proj[:12, :7] * 4).astype(np.float32)}


def test_compute_patch_fid_is_the_jax_packages():
    """The whole protocol (two patch passes per image, images smaller than
    the patch skipped, FID / KID over the kept features, IS over the fake
    logits) returns the same dict from the same feature extractor."""
    rng = np.random.default_rng(4)
    sizes = [(200, 264), (64, 300), (130, 130)]
    real = [rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
            for h, w in sizes]
    fake = [np.clip(r + 0.2 * rng.standard_normal(r.shape), -1, 1)
            .astype(np.float32) for r in real]
    ref = jm.compute_patch_fid(iter(real), iter(fake), _features, patch=64)
    got = pm.compute_patch_fid(iter(real), iter(fake), _features, patch=64)
    assert got == ref
    assert got["n_real"] == got["n_fake"] > 0 and "inception_mean" in got
