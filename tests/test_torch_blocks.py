"""Each block of ``onedc_tpu_torch/nn/blocks.py`` against its JAX module
on the same (converted) weights, f32 on the CPU, rtol = atol = 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onedc_tpu.nn import blocks as jb
from onedc_tpu_torch.nn import blocks as pb
from onedc_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_common import fill_params, nchw, nhwc

TOL = dict(rtol=1e-4, atol=1e-4)

# name -> (flax module, port module, input NHWC shape)
CASES = {
    "DepthConv": (jb.DepthConv(32, 32), pb.DepthConv(32, 32), (2, 8, 8, 32)),
    "DepthConv_adaptor": (jb.DepthConv(32, 64), pb.DepthConv(32, 64),
                          (1, 8, 8, 32)),
    "ConvFFN3": (jb.ConvFFN3(32), pb.ConvFFN3(32), (2, 8, 8, 32)),
    "DepthConvBlock4": (jb.DepthConvBlock4(64, 32),
                        pb.DepthConvBlock4(64, 32), (1, 8, 8, 64)),
    "SubpelConv1x1": (jb.SubpelConv1x1(16), pb.SubpelConv1x1(32, 16),
                      (1, 4, 6, 32)),
    "ResidualBlockUpsample": (jb.ResidualBlockUpsample(32, 64),
                              pb.ResidualBlockUpsample(32, 64),
                              (2, 4, 4, 32)),
    "ResnetBlockVQ": (jb.ResnetBlockVQ(64), pb.ResnetBlockVQ(64),
                      (2, 8, 8, 64)),
    "ResnetBlockVQ_nin_shortcut": (jb.ResnetBlockVQ(64, 32),
                                   pb.ResnetBlockVQ(64, 32), (1, 8, 8, 64)),
    "AttnBlockVQ": (jb.AttnBlockVQ(64), pb.AttnBlockVQ(64), (2, 4, 6, 64)),
    "UpsampleGroup": (jb.UpsampleGroup(32, 64), pb.UpsampleGroup(32, 64),
                      (1, 4, 4, 32)),
    "UpsampleConv2x": (jb.UpsampleConv2x(32), pb.UpsampleConv2x(64, 32),
                       (1, 4, 5, 64)),
    "GroupNorm": (jb.GroupNorm(32, 1e-6), pb.GroupNorm(64, 32, 1e-6),
                  (2, 5, 7, 64)),
}


def _pair(name, seed=0):
    jmod, pmod, shape = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    params = fill_params(shapes, rng)
    pmod.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmod, params, pmod.eval(), x


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    jmod, params, pmod, x = _pair(name)
    ref = np.asarray(jax.jit(jmod.apply)(params, x))
    with torch.no_grad():
        out = nhwc(pmod(nchw(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("shape", [(1, 8, 8, 64), (3, 5, 7, 32)])
def test_group_norm_affine_matches_jax(shape):
    rng = np.random.default_rng(3)
    # a large common offset makes E[x^2] - mean^2 cancel badly in f32
    x = (rng.standard_normal(shape) + 50.0).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jm, ja = jax.jit(jb.group_norm_affine)(x, scale, bias)
    pm, pa = pb.group_norm_affine(nchw(x), torch.from_numpy(scale),
                                  torch.from_numpy(bias))
    assert pm.dtype == pa.dtype == torch.float32
    assert torch.isfinite(pm).all()
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=2e-3)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=2e-3,
                               atol=2e-3 * np.abs(np.asarray(ja)).max())
    # the affine reproduces GroupNorm: apply it and compare normalised x
    ref = np.asarray(jax.jit(jb.group_norm)(x, scale, bias))
    np.testing.assert_allclose(nhwc(pb.apply_affine(nchw(x), pm, pa)), ref,
                               rtol=1e-3, atol=1e-3)


def test_group_norm_affine_clamps_variance():
    """A constant group has E[x^2] - mean^2 <= 0 in f32: clamped, finite."""
    x = torch.full((2, 32, 3, 3), 7.3)
    mul, add = pb.group_norm_affine(x, torch.ones(32), torch.zeros(32))
    assert torch.isfinite(mul).all() and torch.isfinite(add).all()
    assert (mul > 0).all()
