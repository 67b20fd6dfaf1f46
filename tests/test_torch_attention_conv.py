"""The modules that hold the port's kernels, against the JAX package on
the CPU (where every wrapper takes its plain version): attention dispatch
(K1) and the fused GroupNorm-affine + SiLU + 3x3 conv (K2), plus the
wrapper checks that run before a launch (K1, K1-bwd, K2, K3) and the
bounds ``chip_smoke.py`` holds the kernels against. The kernels
themselves run only on the card: ``test_kernels_on_card`` holds each
against its plain version there and skips here; no test here launches a
kernel."""

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


def test_kernel_route_is_the_jax_rule_within_k1s_head_dims():
    """On the card both attention entry points route by ``can_flash`` alone,
    and K1's checks admit each head dim that the rule sends it on the
    model's paths: 8, 40, 80 and 160 in both dtypes, and the VAE
    mid-block's single 512-wide head in bf16 (a 512x704 image: a 64x88
    grid, not a multiple of its 16-pixel window, one attention over 5632
    tokens, which the JAX package also sends to its Pallas kernel). Other
    head dims, and 512 in f32, raise instead of reaching a plain version."""

    def check(d, dtype):
        q = torch.empty((1, 256, 1, d), dtype=dtype)
        k1._check(q, q, q)

    assert patt.can_flash(64 * 88, 64 * 88)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (8, 40, 80, 160):
            check(d, dtype)
        for d in (12, 168, 256):
            with pytest.raises(ValueError):
                check(d, dtype)
    check(512, torch.bfloat16)
    with pytest.raises(ValueError):
        check(512, torch.float32)
    q = torch.empty((1, 256, 1, 512), dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # K1-bwd: D <= 128
        k1._check_bwd(q, q, q, q, torch.empty((1, 1, 256)),
                      torch.empty((1, 1, 256)))


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


def _k2_args(b=1, h=4, w=4, cin=64, cout=64, dtype=torch.bfloat16):
    return (torch.zeros((b, h, w, cin), dtype=dtype),
            torch.ones((b, cin)), torch.zeros((b, cin)),
            torch.zeros((3, 3, cin, cout), dtype=dtype),
            torch.zeros((cout,), dtype=dtype))


def _misaligned(t):
    """t's values in a contiguous tensor whose data starts 2 bytes past a
    16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:]
    return flat.view(t.shape)


@pytest.mark.parametrize("bad", ["dtype", "cin", "cout", "mul_shape",
                                 "strided", "mul_dtype", "cin_bf16",
                                 "cout_bf16", "cin_f32", "cout_f32",
                                 "w_dtype", "bias_dtype", "misaligned"])
def test_k2_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """Both kernels (bf16 and f32, on wgmma) take Cin and Cout in multiples
    of 64, one dtype throughout and contiguous, 16-byte aligned tensors."""
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
        x = torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16)[:, :, ::2]
    elif bad == "mul_dtype":
        mul = mul.to(torch.bfloat16)
    elif bad == "cin_bf16":
        x, mul, add, w, bias = _k2_args(cin=96)
    elif bad == "cout_bf16":
        x, mul, add, w, bias = _k2_args(cout=32)
    elif bad == "cin_f32":  # the f32 mma.sync kernel took Cin 96
        x, mul, add, w, bias = _k2_args(cin=96, dtype=torch.float32)
    elif bad == "cout_f32":  # ... and Cout 32
        x, mul, add, w, bias = _k2_args(cout=32, dtype=torch.float32)
    elif bad == "w_dtype":
        w = w.float()
    elif bad == "bias_dtype":
        bias = bias.float()
    elif bad == "misaligned":
        x = _misaligned(x)
    with pytest.raises((TypeError, ValueError)):
        k2._check(x, mul, add, w, bias)
    k2._check(*_k2_args())  # the good cases pass
    k2._check(*_k2_args(cin=128, cout=192, dtype=torch.float32))


def test_k3_wrapper_takes_f32_only():
    """K3 (the input gradient of the f32 training conv) has no bf16
    kernel, and takes channels in multiples of 64 as K2; its wrapper says
    so before a launch."""
    x, _, _, w, _ = _k2_args()
    with pytest.raises(TypeError):
        k2._check_conv(x, w, (torch.float32,))
    with pytest.raises(ValueError):
        k2._check_conv(x.float(), w[..., :32].float().contiguous(),
                       (torch.float32,))
    k2._check_conv(x.float(), w.float(), (torch.float32,))


def test_k3_weight_copy_is_the_flipped_weights_in_bf16():
    """K3's one-pass weight copy (transposed and rounded, not flipped),
    read in the kernel's flipped tap order, is exactly
    ``flip_weights(w)`` rounded to bf16, and a contiguous (3, 3, Cout,
    Cin) tensor, as the kernel's TMA tensor map needs."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((3, 3, 64, 128)).astype(
        np.float32))
    wk = k2.dx_weights(w)
    assert wk.dtype == torch.bfloat16 and wk.shape == (3, 3, 128, 64)
    assert wk.is_contiguous()
    assert torch.equal(wk.flip(0, 1), k2.flip_weights(w).to(torch.bfloat16))


@pytest.mark.parametrize("shape,affine,by,ms", [
    # 2*2*64*64*512*512*9 FLOP / 989e12; bytes 2*64*64*1024*4 + 9*512*512*4
    # + 2*2*512*4 + 512*4 = 43,001,856 / 3.35e12 (0.012836 ms)
    ((2, 64, 64, 512, 512), True, "operations", 38654705664 / 989e12 * 1e3),
    # 154,618,822,656 FLOP (0.156339 ms); bytes 2*512*512*256*4 +
    # 9*128*128*4 = 537,460,736: f32 x and out bind the 128-channel level
    ((2, 512, 512, 128, 128), False, "bytes", 537460736 / 3.35e12 * 1e3),
])
def test_f32_conv_bound_by_hand(shape, affine, by, ms):
    """chip_smoke.py's bound of f32 K2 / K3 at two ``train512`` shapes:
    bf16 tensor-core FLOPs (the kernels round their operands to bf16)
    against f32 bytes of x, w, out (and mul, add, bias for K2)."""
    import chip_smoke as cs
    bnd, got = cs._conv_bound(*shape, 4, affine)
    assert (got, bnd) == (by, pytest.approx(ms, rel=1e-9))


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "mismatch", "strided",
                                 "head_dim_odd", "misaligned"])
def test_k1_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """The forward kernels take head dims in multiples of 8 up to 160; q,
    k, v of one dtype, contiguous and 16-byte aligned (the rule of the bf16
    kernel's TMA tensor maps)."""
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
    elif bad == "head_dim_odd":
        q, k, v = t(1, 64, 2, 36), t(1, 32, 2, 36), t(1, 32, 2, 36)
    elif bad == "misaligned":
        v = _misaligned(v)
    with pytest.raises((TypeError, ValueError)):
        k1._check(q, k, v)
    k1._check(t(1, 64, 2, 40), t(1, 32, 2, 40), t(1, 32, 2, 40))


@pytest.mark.parametrize("shape,by,ms", [
    ((1, 9216, 8, 40), "exponentials", 0.17578),
    ((1, 2304, 8, 80), "operations", 0.013741),
])
def test_k1_bound_counts_the_exponentials(shape, by, ms):
    """chip_smoke.py's bound of K1 at the decode's two shapes: N*N*H
    exponentials at 16 per clock per SM bind D = 40; the tensor cores bind
    D = 80. A 768x768 decode's K1 bound is 5 x 0.1758 + 5 x 0.0137 ms."""
    import chip_smoke as cs
    bnd, got = cs.attention_bound(*shape, 2)
    assert (got, bnd) == (by, pytest.approx(ms, rel=1e-3))
    # the backward recomputes P once: the same exponentials, 2.5x the FLOPs
    b, n, h, _ = shape
    bwd, _ = cs.attention_bound(*shape, 4, backward=True)
    assert bwd >= cs.bound_ms(0.0, 0.0, float(b) * h * n * n)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_di_reads_the_rounded_dout(dtype):
    """``bwd_di``, the di that autograd hands K1-bwd, is rowsum(out *
    dout) with dout rounded to bf16, as the kernel reads dout for dP = dO
    V^T: (B, H, N) f32, contiguous. For f32 that differs from the sum with
    the unrounded dout."""
    gen = torch.Generator().manual_seed(0)
    out, dout = (torch.randn((2, 33, 3, 8), generator=gen).to(dtype)
                 for _ in range(2))
    di = k1.bwd_di(out, dout)
    assert di.shape == (2, 3, 33) and di.dtype == torch.float32
    assert di.is_contiguous()
    want = torch.einsum("bnhd,bnhd->bhn", out.float(),
                        dout.bfloat16().float())
    torch.testing.assert_close(di, want, rtol=1e-6, atol=1e-6)
    exact = torch.einsum("bnhd,bnhd->bhn", out.float(), dout.float())
    assert torch.equal(want, exact) == (dtype == torch.bfloat16)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "dout_shape",
                                 "dout_dtype", "dout_strided",
                                 "dout_misaligned", "q_strided",
                                 "q_misaligned", "lse_shape", "lse_dtype",
                                 "di_shape", "di_dtype", "lse_strided",
                                 "head_dim_odd"])
def test_k1_bwd_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """K1-bwd takes the forward's operands (one dtype, bf16 or f32, head
    dims in multiples of 8) with D at most 128; dout of q's shape and dtype,
    contiguous and 16-byte aligned (its producer warps read every row with
    16-byte loads); lse and di (B, H, N) f32, contiguous. Each case raises
    before any library is loaded."""
    def t(*s, dtype=torch.float32):
        return torch.zeros(s, dtype=dtype)
    q, k, v = t(2, 64, 2, 40), t(2, 32, 2, 40), t(2, 32, 2, 40)
    dout, lse, di = t(2, 64, 2, 40), t(2, 2, 64), t(2, 2, 64)
    if bad == "dtype":
        q, k, v, dout = (x.half() for x in (q, k, v, dout))
    elif bad == "head_dim":
        q, k, v, dout = t(2, 64, 2, 136), t(2, 32, 2, 136), \
            t(2, 32, 2, 136), t(2, 64, 2, 136)
    elif bad == "dout_shape":
        dout = t(2, 32, 2, 40)
    elif bad == "dout_dtype":
        dout = dout.to(torch.bfloat16)
    elif bad == "dout_strided":
        dout = t(2, 64, 2, 80)[..., ::2]
    elif bad == "dout_misaligned":
        dout = _misaligned(dout)
    elif bad == "q_strided":
        q = t(2, 64, 4, 40)[:, :, ::2]
    elif bad == "q_misaligned":
        q = _misaligned(q)
    elif bad == "lse_shape":
        lse = t(2, 64, 2)
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "di_shape":
        di = t(2, 2, 32)
    elif bad == "di_dtype":
        di = di.to(torch.bfloat16)
    elif bad == "lse_strided":
        lse = t(2, 64, 2).transpose(1, 2)
    elif bad == "head_dim_odd":
        q, k, v, dout = t(2, 64, 2, 36), t(2, 32, 2, 36), \
            t(2, 32, 2, 36), t(2, 64, 2, 36)
    with pytest.raises((TypeError, ValueError)):
        k1._check_bwd(q, k, v, dout, lse, di)
    # the good cases pass: f32 and bf16, D = 8 and 128
    for d, dtype in ((8, torch.float32), (128, torch.bfloat16)):
        k1._check_bwd(t(2, 64, 2, d, dtype=dtype), t(2, 32, 2, d, dtype=dtype),
                      t(2, 32, 2, d, dtype=dtype), t(2, 64, 2, d, dtype=dtype),
                      t(2, 2, 64), t(2, 2, 64))


@pytest.mark.parametrize("bad", ["head_dim", "misaligned", "mixed"])
def test_k1_f32_forward_takes_the_bf16_rules(bad):
    """The f32 forward (the training path, now on the bf16 kernel's wgmma
    body) takes what the bf16 one takes: D in multiples of 8 up to 160,
    contiguous, 16-byte aligned (its producer warps load 16 bytes at a
    time), q, k, v of one dtype."""
    def t(*s):
        return torch.zeros(s, dtype=torch.float32)
    q, k, v = t(1, 64, 2, 8), t(1, 32, 2, 8), t(1, 32, 2, 8)
    if bad == "head_dim":
        q, k, v = t(1, 64, 2, 168), t(1, 32, 2, 168), t(1, 32, 2, 168)
    elif bad == "misaligned":
        k = _misaligned(k)
    elif bad == "mixed":
        v = v.to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        k1._check(q, k, v)
    k1._check(t(1, 64, 2, 8), t(1, 32, 2, 8), t(1, 32, 2, 8))
    k1._check(t(1, 64, 2, 160), t(1, 32, 2, 160), t(1, 32, 2, 160))


@pytest.mark.parametrize("shape,lse_by,lse_ms,bwd_by,bwd_ms", [
    # forward: exponentials 2*8*4096*4096 = 268,435,456 over 132*16*1.83e9
    # per s (FLOPs 4*2*8*4096^2*40 = 4.29e10: 0.0434 ms; bytes of q, k, v,
    # o and the lse, 42,205,184: 0.0126 ms); backward: 10*2*8*4096^2*40 =
    # 107,374,182,400 FLOPs over 989e12 (bytes 7*2,621,440*4 + 2*262,144 =
    # 73,924,608: 0.0221 ms; exponentials 0.0695 ms)
    ((2, 4096, 8, 40), "exponentials", 268435456 / (132 * 16 * 1.83e9) * 1e3,
     "operations", 107374182400 / 989e12 * 1e3),
    # D = 8: 64*2304^2 = 339,738,624 exponentials bind both directions
    # (forward FLOPs 0.0110 ms, backward 0.0275 ms)
    ((1, 2304, 64, 8), "exponentials", 339738624 / (132 * 16 * 1.83e9) * 1e3,
     "exponentials", 339738624 / (132 * 16 * 1.83e9) * 1e3),
])
def test_k1_train_bounds_by_hand(shape, lse_by, lse_ms, bwd_by, bwd_ms):
    """chip_smoke.py's bounds of K1 f32 (with the row LSE) and K1-bwd at the
    largest 512x512 training shape and the encoder UNet's D = 8 attention
    of the 768x768 step, worked by hand."""
    import chip_smoke as cs
    bnd, by = cs.attention_bound(*shape, 4, lse=True)
    assert (by, bnd) == (lse_by, pytest.approx(lse_ms, rel=1e-9))
    bnd, by = cs.attention_bound(*shape, 4, backward=True)
    assert (by, bnd) == (bwd_by, pytest.approx(bwd_ms, rel=1e-9))


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
    """K1, K1-bwd, K2 and K3 against their plain versions on the card, bf16
    and f32 (ragged sequence lengths and image edges, head dims 8 to 160,
    Cout 64, 128 and 192, the row log-sum-exp, K1-bwd's determinism)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g, device=cuda_device)

    for (b, n, h, d) in [(1, 2304, 8, 80), (2, 300, 2, 40), (1, 200, 1, 160),
                         (1, 330, 4, 8)]:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (rnd(b, n, h, d).to(dtype) for _ in range(3))
            out, lse = k1.flash_attention_cuda(q, k, v, d ** -0.5,
                                               with_lse=True)
            assert _within(out, k1.attention_plain(q, k, v, d ** -0.5))
            lse_ref = k1.attention_lse_plain(q, k, d ** -0.5)
            assert (lse - lse_ref).abs().max() <= 2e-2
            if dtype != torch.float32 or d > k1.MAX_HEAD_DIM_BWD:
                continue
            # K1-bwd in f32 (the training path), ragged N, D = 8 to 80, and
            # bit-identical on a second launch (no atomics)
            dout = rnd(b, n, h, d)
            di = (out * dout).sum(-1).transpose(1, 2).contiguous()
            grads = k1.flash_attention_bwd_cuda(q, k, v, dout, lse, di,
                                                d ** -0.5)
            refs = k1.attention_bwd_plain(q, k, v, out, dout, lse, d ** -0.5)
            assert all(_within(a, r) for a, r in zip(grads, refs))
            again = k1.flash_attention_bwd_cuda(q, k, v, dout, lse, di,
                                                d ** -0.5)
            assert all(torch.equal(a, b) for a, b in zip(grads, again))
    for (b, h, w_, cin, cout) in [(2, 24, 40, 64, 64), (1, 20, 36, 128, 128),
                                  (1, 20, 36, 64, 192), (1, 48, 48, 256, 192)]:
        for dtype in (torch.bfloat16, torch.float32):
            x = rnd(b, h, w_, cin).to(dtype)
            mul, add = 1 + 0.1 * rnd(b, cin), 0.1 * rnd(b, cin)
            w = (rnd(3, 3, cin, cout) / (9 * cin) ** 0.5).to(dtype)
            bias = (0.1 * rnd(cout)).to(dtype)
            out = k2.affine_silu_conv3x3(x, mul, add, w, bias)
            assert _within(out, k2.affine_silu_conv3x3_plain(x, mul, add, w,
                                                             bias))
        # K3: the input gradient (b, h, w_, cin -> cout) of a conv cout ->
        # cin
        g, w = rnd(b, h, w_, cin), rnd(3, 3, cout, cin) / (9 * cin) ** 0.5
        assert _within(k2.conv3x3_dx_cuda(g, w), k2.conv3x3_dx_plain(g, w))
