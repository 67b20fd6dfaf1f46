"""The modules that hold the port's two kernels, against the JAX package on
the CPU (where every wrapper takes its plain version): attention dispatch
(K1) and the fused GroupNorm-affine + SiLU + 3x3 conv (K2), plus the
wrapper checks that run before a launch. The kernels themselves run only
on the card: ``test_kernels_on_card`` holds each against its plain version
there and skips here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onedc_tpu.nn import attention as jatt
from onedc_tpu.nn.vae import VaeResnetBlock as JaxVaeResnetBlock
from onedc_tpu.ops import pallas_conv as jconv
from onedc_tpu_torch.nn import attention as patt
from onedc_tpu_torch.nn.vae import VaeResnetBlock, hwio_conv_weights
from onedc_tpu_torch.ops import conv3x3 as k2
from onedc_tpu_torch.ops import flash_attention as k1
from onedc_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_common import fill_params, nchw, nhwc

TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("b,n,m,h,d", [(2, 64, 64, 8, 40), (1, 256, 16, 2, 80),
                                       (1, 2048, 2048, 1, 8)])
def test_attention_bnhd_matches_jax(b, n, m, h, d):
    q, k, v = _qkv(np.random.default_rng(n), (b, n, h, d), (b, m, h, d),
                   (b, m, h, d))
    before = k1.launches
    out = patt.multi_head_attention_bnhd(*map(torch.from_numpy, (q, k, v)))
    ref = jax.jit(jatt.multi_head_attention_bnhd)(q, k, v)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert k1.launches == before  # CPU tensors never reach the kernel


def test_attention_bhnd_matches_jax_einsum():
    q, k, v = _qkv(np.random.default_rng(5), (2, 1, 256, 64), (2, 1, 256, 64),
                   (2, 1, 256, 64))
    out = patt.multi_head_attention(*map(torch.from_numpy, (q, k, v)))
    ref = jax.jit(jatt.einsum_attention, static_argnums=3)(q, k, v, 0.125)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_can_flash_rule_is_the_jax_rule():
    for n, m in [(2048, 2048), (9216, 9216), (2304, 2304), (1536, 1536),
                 (9216, 144), (2176, 2048), (2100, 2100)]:
        assert patt.can_flash(n, m) == jatt.can_flash(n, m), (n, m)


@pytest.mark.parametrize("shape", [(1, 8, 8, 32, 32), (2, 5, 7, 64, 32)])
def test_affine_silu_conv3x3_matches_jax(shape):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    mul = (1 + 0.1 * rng.standard_normal((b, cin))).astype(np.float32)
    add = (0.1 * rng.standard_normal((b, cin))).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    out = k2.affine_silu_conv3x3(*map(torch.from_numpy,
                                      (x, mul, add, wt, bias))).numpy()
    for ref in (jax.jit(jconv.affine_silu_conv3x3)(x, mul, add, wt, bias),
                jax.jit(jconv._gn_silu_conv_ref)(x, mul, add, wt, bias)):
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 32)])
def test_vae_resnet_block_matches_jax(cin, cout):
    rng = np.random.default_rng(cin * cout)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    jmod = JaxVaeResnetBlock(cout)
    params = fill_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x),
                         rng)
    pmod = VaeResnetBlock(cin, cout)
    pmod.load_state_dict(state_dict_from_jax(params), strict=True)
    before = k2.launches
    with torch.no_grad():
        out = nhwc(pmod(nchw(x)))
    np.testing.assert_allclose(out, np.asarray(jax.jit(jmod.apply)(params, x)),
                               **TOL)
    assert k2.launches == before


def _k2_args(b=1, h=4, w=4, cin=32, cout=8, dtype=torch.bfloat16):
    return (torch.zeros((b, h, w, cin), dtype=dtype),
            torch.ones((b, cin)), torch.zeros((b, cin)),
            torch.zeros((3, 3, cin, cout), dtype=dtype),
            torch.zeros((cout,), dtype=dtype))


@pytest.mark.parametrize("bad", ["dtype", "cin", "cout", "mul_shape",
                                 "strided", "mul_dtype"])
def test_k2_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, mul, add, w, bias = _k2_args()
    if bad == "dtype":
        x = x.float()
    elif bad == "cin":
        x, mul, add, w, bias = _k2_args(cin=48)
    elif bad == "cout":
        x, mul, add, w, bias = _k2_args(cout=12)
    elif bad == "mul_shape":
        mul = mul[:, :16]
    elif bad == "strided":
        x = torch.zeros((1, 4, 8, 32), dtype=torch.bfloat16)[:, :, ::2]
    elif bad == "mul_dtype":
        mul = mul.to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        k2._check(x, mul, add, w, bias)
    k2._check(*_k2_args())  # the good case passes


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "mismatch", "strided"])
def test_k1_wrapper_rejects_what_the_kernel_does_not_take(bad):
    def t(*s):
        return torch.zeros(s, dtype=torch.bfloat16)
    q, k, v = t(1, 64, 2, 40), t(1, 32, 2, 40), t(1, 32, 2, 40)
    if bad == "dtype":
        q = q.float()
    elif bad == "head_dim":
        q, k, v = t(1, 64, 2, 168), t(1, 32, 2, 168), t(1, 32, 2, 168)
    elif bad == "mismatch":
        k = t(1, 32, 3, 40)
    elif bad == "strided":
        q = t(1, 64, 2, 80)[..., ::2]
    with pytest.raises((TypeError, ValueError)):
        k1._check(q, k, v)
    k1._check(t(1, 64, 2, 40), t(1, 32, 2, 40), t(1, 32, 2, 40))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def test_vae_conv_weights_laid_out_hwio_once():
    """``hwio_conv_weights`` re-lays the K2 conv weights in memory only: the
    parameters keep their OIHW shape and values, the block its output, and
    the per-call OIHW -> HWIO permute becomes a view."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    params = fill_params(jax.eval_shape(JaxVaeResnetBlock(32).init,
                                        jax.random.PRNGKey(0), x), rng)
    pmod = VaeResnetBlock(64, 32)
    pmod.load_state_dict(state_dict_from_jax(params), strict=True)
    before = {k: v.clone() for k, v in pmod.state_dict().items()}
    with torch.no_grad():
        want = pmod(nchw(x))
    hwio_conv_weights(pmod)
    for conv in (pmod.conv1, pmod.conv2):
        assert conv.weight.permute(2, 3, 1, 0).is_contiguous()
    after = pmod.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    with torch.no_grad():
        assert torch.equal(pmod(nchw(x)), want)


def _within(out, ref, rel_l2=1e-2, rel_max=2e-2):
    """chip_smoke.py's kernel limits, relative to the plain output's own
    scale with no absolute floor."""
    diff = out.float() - ref.float()
    ref = ref.float()
    return (diff.norm() <= rel_l2 * ref.norm()
            and diff.abs().max() <= rel_max * ref.abs().max())


@pytest.mark.cuda
def test_kernels_on_card(cuda_device):
    """K1 and K2 against their plain versions on the card (bf16)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g, device=cuda_device)

    q, k, v = (rnd(1, 2304, 8, 80).to(torch.bfloat16) for _ in range(3))
    out = k1.flash_attention(q, k, v, 80 ** -0.5)
    assert _within(out, k1.attention_plain(q, k, v, 80 ** -0.5))
    x = rnd(2, 24, 40, 64).to(torch.bfloat16)
    mul, add = 1 + 0.1 * rnd(2, 64), 0.1 * rnd(2, 64)
    w = (rnd(3, 3, 64, 32) / 24).to(torch.bfloat16)
    bias = (0.1 * rnd(32)).to(torch.bfloat16)
    out = k2.affine_silu_conv3x3(x, mul, add, w, bias)
    assert _within(out, k2.affine_silu_conv3x3_plain(x, mul, add, w, bias))
