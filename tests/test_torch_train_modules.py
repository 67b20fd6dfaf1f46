"""The port's training-path modules against the JAX package on the CPU: the
forward and the gradient of every input and parameter (torch autograd
against ``jax.grad`` / ``jax.vjp``, JAX at ``highest`` precision), at the
tiny geometry of ``torch_port_common`` with 64x64 images; and the plain
versions of the training kernels (K1-bwd, K3, K2's backward) against the
JAX package's references.

Every test draws its inputs and a random cotangent R with numpy and
differentiates sum(outputs * R) in both frameworks. The encoder UNet is
held inside the codec encoder, and the whole OneDC forward and its
gradients in ``test_torch_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from onedc_tpu.entropy import bound as jbound
from onedc_tpu.entropy import fourpart as jfour
from onedc_tpu.entropy import gaussian as jgauss
from onedc_tpu.models.codec import CodecEncoder as JaxCodecEncoder
from onedc_tpu.models.codec import HyperEncoder as JaxHyperEncoder
from onedc_tpu.nn import attention as jatt
from onedc_tpu.nn import blocks as jblocks
from onedc_tpu.nn.fsq import FSQ as JaxFSQ
from onedc_tpu.nn.unet_enc import SelfAttention2D as JaxSelfAttention2D
from onedc_tpu.nn.vae import VaeDownBlock as JaxVaeDownBlock
from onedc_tpu.ops import pallas_conv as jconv
from onedc_tpu_torch.entropy import bound as pbound
from onedc_tpu_torch.entropy import fourpart as pfour
from onedc_tpu_torch.entropy import gaussian as pgauss
from onedc_tpu_torch.models.codec import CodecEncoder, HyperEncoder
from onedc_tpu_torch.nn import blocks as pblocks
from onedc_tpu_torch.nn.fsq import FSQ
from onedc_tpu_torch.nn.unet_enc import SelfAttention2D
from onedc_tpu_torch.nn.vae import VaeDownBlock
from onedc_tpu_torch.ops import conv3x3 as k2
from onedc_tpu_torch.ops import flash_attention as k1
from onedc_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_common import (  # noqa: F401  (a fixture)
    fill_params,
    nchw,
    nhwc,
    one_torch_thread,
    port_model,
    TINY,
    tiny_jax_model,
    to_np,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# relative L2 limits: ||port - jax|| <= tol * ||jax||, per tensor
FWD_REL_L2 = 1e-4
GRAD_REL_L2 = 1e-3
# plus this share of the gradient's global norm over the test's tensors: a
# gradient that is zero in exact arithmetic (the key bias under a softmax)
# is rounding noise of either framework
GRAD_FLOOR = 1e-6


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_fwd(out, ref, what):
    err = rel_l2(out, ref)
    assert err <= FWD_REL_L2, f"{what}: relative L2 {err:.2e}"


def assert_grads(got: dict, want: dict):
    """got/want: name -> array, torch layout, the same keys."""
    assert set(got) == set(want), set(got) ^ set(want)
    total = np.sqrt(sum(np.sum(np.asarray(w, np.float64) ** 2)
                        for w in want.values()))
    for name in sorted(want):
        g, w = np.asarray(got[name], np.float64), np.asarray(want[name],
                                                            np.float64)
        err = np.linalg.norm(g - w)
        lim = GRAD_REL_L2 * np.linalg.norm(w) + GRAD_FLOOR * total
        assert err <= lim, (f"grad {name}: |diff| {err:.3e} > {lim:.3e} "
                            f"(|jax| {np.linalg.norm(w):.3e})")


def param_grads(module: torch.nn.Module, prefix: str = "") -> dict:
    return {prefix + n: to_np(p.grad) for n, p in module.named_parameters()}


def jax_param_grads(tree, prefix: str = "") -> dict:
    return {prefix + k: v.numpy()
            for k, v in state_dict_from_jax(tree).items()}


def cotangent(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a, grad: bool = False) -> torch.Tensor:
    out = torch.from_numpy(np.array(a, np.float32))
    return out.requires_grad_() if grad else out


# ---------------------------------------------------------------------------
# 1-4: bounds, Gaussian bits, FSQ, four-part prior
# ---------------------------------------------------------------------------

def test_lower_bound_and_ste_round_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    g = cotangent(rng, x.shape)  # both signs: the pass-through rule
    out, vjp = jax.vjp(lambda a: jbound.lower_bound(a, 0.2), x)
    xt = t(x, True)
    yt = pbound.lower_bound(xt, 0.2)
    yt.backward(t(g))
    np.testing.assert_array_equal(to_np(yt), np.asarray(out))
    np.testing.assert_array_equal(to_np(xt.grad), np.asarray(vjp(g)[0]))
    # blocked exactly where x < bound and g >= 0
    blocked = (x < 0.2) & (g >= 0)
    assert blocked.any() and (to_np(xt.grad)[blocked] == 0).all()

    x = 3 * x
    out, vjp = jax.vjp(jbound.ste_round, x)
    xt = t(x, True)
    yt = pbound.ste_round(xt)
    yt.backward(t(g))
    np.testing.assert_array_equal(to_np(yt), np.asarray(out))
    np.testing.assert_array_equal(to_np(xt.grad), np.asarray(vjp(g)[0]))


def test_add_uniform_noise_draws_from_its_generator():
    """``uniform_noise``, the codec's training noise that the step adds to
    y_res: U(-0.5, 0.5), the same draw from the same seed, no gradient."""
    a, b = (pbound.uniform_noise((4, 1000), torch.Generator().manual_seed(3),
                                 "cpu", torch.float32) for _ in range(2))
    assert torch.equal(a, b) and not a.requires_grad
    assert a.min() >= -0.5 and a.max() < 0.5 and a.std() > 0.25
    x = torch.zeros(4, 1000, requires_grad=True)
    (x + a).sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))  # the noise is constant


@pytest.mark.parametrize("case", ["gaussian_prob", "probs_to_bits",
                                  "bits_train", "bits_eval"])
def test_gaussian_bits_match_jax(case):
    rng = np.random.default_rng(1)
    # scales below the 0.11 bound exercise lower_bound's pass-through; y
    # of the scale's own size, as the codec's residuals are (deep in the
    # tail, eval's 1 - erf cancels and both frameworks' f32 erf give noise)
    sigma = (np.abs(rng.standard_normal((2, 4, 4, 16))) + 0.05).astype(
        np.float32)
    y = (sigma * rng.standard_normal(sigma.shape)).astype(np.float32)
    if case == "probs_to_bits":
        y = rng.uniform(1e-7, 1.0, y.shape).astype(np.float32)
        jf, pf = jgauss.probs_to_bits, pgauss.probs_to_bits
        args = (y,)
    else:
        jf, pf = {
            "gaussian_prob": (jgauss.gaussian_prob, pgauss.gaussian_prob),
            "bits_train": (jgauss.gaussian_bits, pgauss.gaussian_bits),
            "bits_eval": (lambda a, s: jgauss.gaussian_bits(a, s, False),
                          lambda a, s: pgauss.gaussian_bits(a, s, False)),
        }[case]
        args = (y, sigma)
    out, vjp = jax.vjp(jax.jit(jf), *args)
    g = cotangent(rng, y.shape)
    targs = [t(a, True) for a in args]
    res = pf(*targs)
    res.backward(t(g))
    assert_fwd(to_np(res), out, case)
    for name, a, w in zip(("y", "sigma"), targs, vjp(g)):
        assert_grads({name: to_np(a.grad)}, {name: np.asarray(w)})


def test_fsq_matches_jax():
    rng = np.random.default_rng(2)
    z = (2 * rng.standard_normal((2, 3, 5, 7))).astype(np.float32)
    levels = [4] * 7
    jfsq, pfsq = JaxFSQ(levels), FSQ(levels)
    (codes, idx), vjp = jax.vjp(jfsq.__call__, z)
    zt = t(z, True)
    pcodes, pidx = pfsq(zt)
    np.testing.assert_array_equal(to_np(pcodes), np.asarray(codes))
    np.testing.assert_array_equal(to_np(pidx), np.asarray(idx))
    assert pidx.dtype == torch.int32
    g = cotangent(rng, z.shape)
    pcodes.backward(t(g))
    want = vjp((g, np.zeros(idx.shape, jax.dtypes.float0)))[0]
    assert_grads({"z": to_np(zt.grad)}, {"z": np.asarray(want)})
    np.testing.assert_allclose(to_np(pfsq.bound(torch.from_numpy(z))),
                               np.asarray(jfsq.bound(z)), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("training,thres", [(True, None), (False, None),
                                            (False, 0.3)])
def test_four_part_prior_matches_jax(training, thres):
    """Both frameworks run the prior with the same three stand-in prior
    nets (tanh of a linear map) and the same reduction."""
    rng = np.random.default_rng(3)
    y = (2 * rng.standard_normal((2, 4, 6, 16))).astype(np.float32)
    common = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    mats = [(rng.standard_normal((32, 32)) / 6).astype(np.float32)
            for _ in range(3)]
    red = (rng.standard_normal((32, 16)) / 6).astype(np.float32)

    def jax_fn(y, common, m0, m1, m2, red):
        steps = [lambda p, m=m: jnp.tanh(p @ m) for m in (m0, m1, m2)]
        return jfour.forward_four_part_prior(
            y, common, steps, reduction=lambda p: p @ red, training=training,
            force_zero_thres=thres)

    outs, vjp = jax.vjp(jax.jit(jax_fn), y, common, *mats, red)
    targs = [t(a, True) for a in (y, common, *mats, red)]
    steps = [lambda p, m=m: torch.tanh(p @ m) for m in targs[2:5]]
    pouts = pfour.forward_four_part_prior(
        targs[0], targs[1], steps, reduction=lambda p: p @ targs[5],
        training=training, force_zero_thres=thres)
    for name, a, b in zip(("y_res", "y_q", "y_hat", "scales_hat"), pouts,
                          outs):
        assert_fwd(to_np(a), b, name)
    gs = [cotangent(rng, o.shape) for o in outs]
    torch.autograd.backward(pouts, [t(g) for g in gs])
    names = ("y", "common", "m0", "m1", "m2", "red")
    assert_grads({n: to_np(a.grad) for n, a in zip(names, targs)},
                 {n: np.asarray(w) for n, w in zip(names, vjp(tuple(gs)))})


# ---------------------------------------------------------------------------
# 5-9: blocks, encoder UNet attention, codec encoders, RD forward, VAE
# ---------------------------------------------------------------------------

def _module_case(jmod, pmod, xs, rng):
    """Forward and gradients of a one-or-more-input module (NHWC inputs in
    JAX, NCHW in the port) on fresh seeded weights."""
    params = fill_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                        *xs), rng)
    pmod.load_state_dict(state_dict_from_jax(params), strict=True)
    out, vjp = jax.vjp(jax.jit(jmod.apply), params, *xs)
    g = cotangent(rng, out.shape)
    txs = [nchw(x).requires_grad_() for x in xs]
    pout = pmod(*txs)
    assert_fwd(nhwc(pout), out, type(pmod).__name__)
    pout.backward(nchw(g))
    jg = vjp(g)
    got = param_grads(pmod)
    want = jax_param_grads(jg[0])
    for i, (tx, w) in enumerate(zip(txs, jg[1:])):
        got[f"input{i}"] = nhwc(tx.grad)
        want[f"input{i}"] = np.asarray(w)
    assert_grads(got, want)


@pytest.mark.parametrize("name", ["BottleneckGroup", "ResnetAttnGroup",
                                  "SelfAttention2D", "VaeDownBlock"])
def test_block_forward_and_grads_match_jax(name):
    rng = np.random.default_rng(4)
    jmod, pmod, shape = {
        "BottleneckGroup": (jblocks.BottleneckGroup(32),
                            pblocks.BottleneckGroup(32), (2, 8, 8, 32)),
        "ResnetAttnGroup": (jblocks.ResnetAttnGroup(32, 2, 1),
                            pblocks.ResnetAttnGroup(32, 2, 1), (1, 6, 8, 32)),
        "SelfAttention2D": (JaxSelfAttention2D(64), SelfAttention2D(64),
                            (2, 6, 6, 64)),
        # stride-2 downsample after the asymmetric (0, 1, 0, 1) pad
        "VaeDownBlock": (JaxVaeDownBlock(64), VaeDownBlock(32, 64),
                         (1, 8, 10, 32)),
    }[name]
    x = rng.standard_normal(shape).astype(np.float32)
    _module_case(jmod, pmod, [x], rng)


# codec tests run 128x128 images, not 64x64: at 64 the /64 level is one
# pixel, and its GroupNorms (2-4 values per group at the tiny widths)
# amplify f32 rounding past the forward limit in either framework
CODEC_IMAGE = 128


def test_codec_and_hyper_encoders_match_jax():
    """g_a (with the encoder UNet, its non-mirrored up path included) and
    the hyper encoder, chained as in the codec, on the tiny model's
    weights: y, sem, z and every gradient."""
    _, params = tiny_jax_model()
    pe = {"params": params["params"]["codec"]["enc"]}
    ph = {"params": params["params"]["codec"]["hyper_enc"]}
    rng = np.random.default_rng(5)
    c8 = CODEC_IMAGE // 8
    x = rng.uniform(-1, 1, (2, CODEC_IMAGE, CODEC_IMAGE, 3)).astype(
        np.float32)
    cond = rng.standard_normal((2, c8, c8, 4)).astype(np.float32)
    n, sem_ch = TINY["bottleneck_ch"], TINY["unet_ch_config"][-1]
    jenc = JaxCodecEncoder(3, 4, n, TINY["unet_ch_config"],
                           ctrl_ch=TINY["ctrl_ch"])
    jhyp = JaxHyperEncoder(n, sem_ch, TINY["internal_ch"], 7)

    def f(pe, ph, x, cond):
        y, sem = jenc.apply(pe, x, cond)
        return y, sem, jhyp.apply(ph, y, sem)

    outs, vjp = jax.vjp(jax.jit(f), pe, ph, x, cond)
    penc = CodecEncoder(3, 4, n, TINY["unet_ch_config"],
                        ctrl_ch=TINY["ctrl_ch"])
    phyp = HyperEncoder(n, sem_ch, TINY["internal_ch"], 7)
    penc.load_state_dict(state_dict_from_jax(pe), strict=True)
    phyp.load_state_dict(state_dict_from_jax(ph), strict=True)
    xt, ct = nchw(x).requires_grad_(), nchw(cond).requires_grad_()
    y, sem = penc(xt, ct)
    pouts = (y, sem, phyp(y, sem))
    for name, a, b in zip(("y", "sem", "z"), pouts, outs):
        assert_fwd(nhwc(a), b, name)
    gs = [cotangent(rng, o.shape) for o in outs]
    torch.autograd.backward(pouts, [nchw(g) for g in gs])
    jg = vjp(tuple(gs))
    got = {**param_grads(penc, "enc."), **param_grads(phyp, "hyper."),
           "x": nhwc(xt.grad), "cond": nhwc(ct.grad)}
    want = {**jax_param_grads(jg[0], "enc."),
            **jax_param_grads(jg[1], "hyper."), "x": np.asarray(jg[2]),
            "cond": np.asarray(jg[3])}
    assert_grads(got, want)


@pytest.fixture(scope="module")
def models():
    jm, params = tiny_jax_model()
    return jm, params, port_model().train().requires_grad_(True)


def test_latent_codec_rd_forward_matches_jax(models):
    """``LatentCodec.forward`` in training, with the noise JAX draws
    (``jax.random.uniform(key, y_res.shape, f32, -0.5, 0.5)``, the call at
    ``codec.py:291``) passed in: every output, and the gradients of
    bpp + sum(x_hat * R) for every codec parameter, the image and the
    latent."""
    jm, params, pm = models
    rng = np.random.default_rng(6)
    c8 = CODEC_IMAGE // 8
    x = rng.uniform(-1, 1, (2, CODEC_IMAGE, CODEC_IMAGE, 3)).astype(
        np.float32)
    cond = rng.standard_normal((2, c8, c8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    r = cotangent(rng, (2, c8, c8, TINY["ctrl_ch"]))
    keys = ("bpp", "bpp_hard_y", "bit", "x_hat", "y_hat", "y_semantic",
            "z_semantic", "z_indices")

    def f(pc, x, cond):
        d = jm.apply({"params": {**params["params"], "codec": pc}}, x, cond,
                     training=True, noise_rng=key,
                     method=lambda m, *a, **k: m.codec(*a, **k))
        return d["bpp"] + jnp.sum(d["x_hat"] * r), {k: d[k] for k in keys}

    (_, jd), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                                has_aux=True))(
        params["params"]["codec"], x, cond)
    noise = jax.random.uniform(key, jd["y_hat"].shape, jnp.float32, -0.5, 0.5)
    xt, ct = nchw(x).requires_grad_(), nchw(cond).requires_grad_()
    pm.zero_grad(set_to_none=True)
    pd = pm.codec(xt, ct, training=True, noise=t(noise))
    (pd["bpp"] + (pd["x_hat"] * nchw(r)).sum()).backward()
    np.testing.assert_array_equal(to_np(pd["z_indices"]), jd["z_indices"])
    for k in keys[:-1]:
        got = to_np(pd[k])
        assert_fwd(nhwc(pd[k]) if got.ndim == 4 else got, jd[k], k)
    want = {**jax_param_grads(grads[0], "codec."), "x": np.asarray(grads[1]),
            "cond": np.asarray(grads[2])}
    got = {n: to_np(p.grad) for n, p in pm.named_parameters()
           if n.startswith("codec.")}
    got.update(x=nhwc(xt.grad), cond=nhwc(ct.grad))
    assert_grads(got, want)


def test_vae_encode_matches_jax(models):
    """``AutoencoderKL.encode`` (mean, clipped logvar) with the gradients of
    every encoder parameter and the image, and ``OneDC.vae_encode_image``
    (the detached posterior mean times the scaling factor)."""
    jm, params, pm = models
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)

    def f(pv, x):
        return jm.apply({"params": {**params["params"], "vae": pv}}, x,
                        method=lambda m, x: m.vae.encode(x))

    (mean, logvar), vjp = jax.vjp(jax.jit(f), params["params"]["vae"], x)
    xt = nchw(x).requires_grad_()
    pm.zero_grad(set_to_none=True)
    pmean, plogvar = pm.vae.encode(xt)
    assert_fwd(nhwc(pmean), mean, "mean")
    assert_fwd(nhwc(plogvar), logvar, "logvar")
    gs = (cotangent(rng, mean.shape), cotangent(rng, logvar.shape))
    torch.autograd.backward((pmean, plogvar), [nchw(g) for g in gs])
    jg = vjp(gs)
    want = {k: v for k, v in jax_param_grads(jg[0], "vae.").items()
            if k.startswith("vae.encoder.")}
    want["x"] = np.asarray(jg[1])
    got = {n: to_np(p.grad) for n, p in pm.named_parameters()
           if n.startswith("vae.encoder.")}
    got["x"] = nhwc(xt.grad)
    assert_grads(got, want)

    ref = jax.jit(lambda p, x: jm.apply(
        p, x, method=lambda m, x: m.vae_encode_image(x)))(params, x)
    lat = pm.vae_encode_image(nchw(x))
    assert not lat.requires_grad
    assert_fwd(nhwc(lat), ref, "vae_encode_image")


# ---------------------------------------------------------------------------
# the plain versions of the training kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [8, 40, 80])
def test_attention_bwd_plain_matches_jax(d):
    """``attention_bwd_plain`` (explicit formulas, K1-bwd's plain version)
    against ``mha_reference_bwd`` (``flash_attention.py:1615``, which takes
    sm_scale 1: q is pre-scaled) and against ``jax.vjp`` of
    ``einsum_attention``; the autograd ``FlashAttention`` (plain halves on
    the CPU) against both."""
    rng = np.random.default_rng(d)
    b, n, m, h = 2, 96, 80, 3
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((b, n, h, d), (b, m, h, d), (b, m, h, d),
                             (b, n, h, d)))
    scale = d ** -0.5
    bh = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v,
                                                                  do)]
    out_j, vjp = jax.vjp(lambda q, k, v: jatt.einsum_attention(q, k, v,
                                                               scale),
                         *bh[:3])
    want_vjp = vjp(bh[3])
    logits = np.einsum("bhqd,bhkd->bhqk", bh[0] * scale, bh[1])
    mx = logits.max(-1)
    l = np.exp(logits - mx[..., None]).sum(-1)
    dq_r, dk_r, dv_r, _ = jfa.mha_reference_bwd(
        bh[0] * scale, bh[1], bh[2], None, None, out_j, l, mx, bh[3])
    want_ref = (np.asarray(dq_r) * scale, dk_r, dv_r)

    qt, kt, vt = (t(a, True) for a in (q, k, v))
    out = k1.attention_plain(qt, kt, vt, scale)
    lse = k1.attention_lse_plain(qt, kt, scale)
    np.testing.assert_allclose(to_np(lse), (mx + np.log(l)).astype(np.float32),
                               rtol=1e-5, atol=1e-5)
    plain = k1.attention_bwd_plain(qt, kt, vt, out, t(do), lse, scale)
    fn_out = k1.FlashAttention.apply(qt, kt, vt, scale)
    fn = torch.autograd.grad(fn_out, (qt, kt, vt), t(do))
    for name, p, f, r, j in zip(("dq", "dk", "dv"), plain, fn, want_ref,
                                want_vjp):
        bhnd = lambda a: to_np(a).transpose(0, 2, 1, 3)  # noqa: E731
        for got in (p, f):
            assert rel_l2(bhnd(got), np.asarray(r)) <= GRAD_REL_L2, name
            assert rel_l2(bhnd(got), np.asarray(j)) <= GRAD_REL_L2, name


def test_conv3x3_plain_matches_the_pallas_kernel_in_interpret_mode():
    """``conv3x3_plain`` (K3's plain version) against the TPU kernel
    ``_conv3x3_pallas_single`` run by Pallas's interpreter on the CPU, and
    ``conv3x3_dx`` / ``conv3x3_dw`` against ``jax.vjp`` of the JAX
    ``conv3x3_same`` (its custom VJP: dx by the kernel on flipped weights,
    dw by XLA)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 16, 24, 128)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 128, 128)) / 34).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jconv._conv3x3_pallas_single(x[0], w)
        out_j, vjp = jax.vjp(jconv.conv3x3_same, jnp.asarray(x),
                             jnp.asarray(w))
        g = cotangent(rng, out_j.shape)
        dx_j, dw_j = vjp(g)
    out = k2.conv3x3_plain(t(x), t(w))
    assert_fwd(to_np(out)[0], ref, "conv3x3")
    assert_fwd(to_np(out), out_j, "conv3x3_same")
    dx = k2.conv3x3_dx(t(g), t(w))
    assert_grads({"dx": to_np(dx),
                  "dw": to_np(k2.conv3x3_dw(t(x), t(g), list(w.shape)))},
                 {"dx": np.asarray(dx_j), "dw": np.asarray(dw_j)})
    np.testing.assert_array_equal(
        to_np(k2.conv3x3_dx_plain(t(g), t(w))), to_np(dx))


@pytest.mark.parametrize("shape", [(2, 6, 10, 32, 64), (1, 9, 7, 64, 32)])
def test_affine_silu_conv3x3_backward_matches_jax(shape):
    """K2's autograd ``AffineSiluConv3x3`` (plain halves on the CPU)
    against ``jax.vjp`` of ``_gn_silu_conv_ref``: dx, dmul, dadd, dw,
    dbias."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(cin * cout)
    args = (rng.standard_normal((b, h, w, cin)).astype(np.float32),
            (1 + 0.1 * rng.standard_normal((b, cin))).astype(np.float32),
            (0.1 * rng.standard_normal((b, cin))).astype(np.float32),
            (rng.standard_normal((3, 3, cin, cout))
             / np.sqrt(9 * cin)).astype(np.float32),
            (0.1 * rng.standard_normal(cout)).astype(np.float32))
    out_j, vjp = jax.vjp(jax.jit(jconv._gn_silu_conv_ref), *args)
    g = cotangent(rng, out_j.shape)
    targs = [t(a, True) for a in args]
    out = k2.affine_silu_conv3x3(*targs)
    assert_fwd(to_np(out), out_j, "affine_silu_conv3x3")
    out.backward(t(g))
    names = ("dx", "dmul", "dadd", "dw", "dbias")
    assert_grads({n: to_np(a.grad) for n, a in zip(names, targs)},
                 {n: np.asarray(r) for n, r in zip(names, vjp(g))})
    assert k2.conv_launches == 0 and k2.launches == 0

