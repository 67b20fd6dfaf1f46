"""The port's Codeformer distillation modules against the JAX package's, on
the CPU at the tiny width: ``nn/swin.py`` (``WindowAttention`` plain,
shifted and with the position embedding, ``DualSwinBlock``), ``nn/vqgan.py``
(the quantizer's indices and straight-through output, the encoder, the
decoder, the soft code), ``models/codeformer.py`` (logits and probs,
``codeformer_losses`` and their gradients), the half-size antialiased
resize of ``OneDC.vqgan_targets``, the Swin / Codeformer / VQGAN porters
bit for bit, and the window that does not divide the grid (JAX asserts,
the port raises). Inputs and weights are seeded numpy draws; the flax
trees come from ``jax.eval_shape`` and ``fill_params``, and reach the port
through ``utils/convert.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from onedc_tpu.models import codeformer as jcf
from onedc_tpu.nn import swin as jswin
from onedc_tpu.nn import vqgan as jvq
from onedc_tpu.utils import port_torch as jport
from onedc_tpu_torch.models import codeformer as pcf
from onedc_tpu_torch.nn import swin as pswin
from onedc_tpu_torch.nn import vqgan as pvq
from onedc_tpu_torch.utils import port_torch as pport
from onedc_tpu_torch.utils.convert import convert_leaf, state_dict_from_jax
from torch_port_common import (  # noqa: F401  (a fixture)
    fill_params,
    one_torch_thread,
    reference_state,
    to_np,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# f32 on both sides (JAX at "highest" matmul precision): relative L2 of a
# module's output against JAX's
REL_L2 = 1e-5
# the VQGAN's deep conv stack and the Codeformer's three Swin pairs: their
# outputs sum more terms, relative L2
DEEP_REL_L2 = 1e-4
# quantizer indices against JAX's: the share that must agree (a near-tie
# in the f32 argmin may flip an index across frameworks, as the CDF
# indexes did)
INDEX_AGREE = 0.99


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_params(module, seed, *inputs, method=None):
    shapes = jax.eval_shape(
        lambda *x: module.init(jax.random.PRNGKey(0), *x, method=method),
        *inputs)
    return fill_params(shapes, np.random.default_rng(seed))


def _load(port_module, params):
    port_module.load_state_dict(state_dict_from_jax(params), strict=True)
    return port_module.eval()


@pytest.mark.parametrize("shifted,pos", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_window_attention_matches_jax(shifted, pos):
    """4x4 windows on an 8x12 grid (2 x 3 windows: the shifted masks act on
    the last window row and column, both on the corner window)."""
    dim, heads, hd, ws = 16, 2, 8, 4
    x = np.random.default_rng(1).standard_normal((2, 8, 12, dim)).astype(
        np.float32)
    jmod = jswin.WindowAttention(dim, heads, hd, ws, shifted, pos)
    params = _jax_params(jmod, 2, jnp.asarray(x))
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    pmod = _load(pswin.WindowAttention(dim, heads, hd, ws, shifted, pos),
                 params)
    with torch.no_grad():
        got = to_np(pmod(torch.from_numpy(x)))
    assert _rel(got, want) <= REL_L2


def test_shift_masks_match_jax():
    for ws in (4, 8, 16):
        for a, b in zip(pswin._shift_masks(ws, ws // 2),
                        jswin._shift_masks(ws, ws // 2)):
            assert np.array_equal(a, b)
    assert pswin.NEG_INF == jswin.NEG_INF == -1e9


def test_dual_swin_block_matches_jax():
    dim, heads, hd, mlp, ws = 32, 2, 16, 64, 4
    x = np.random.default_rng(3).standard_normal((1, 8, 8, dim)).astype(
        np.float32)
    jmod = jswin.DualSwinBlock(dim, heads, hd, mlp, ws, use_pos_embedding=True)
    params = _jax_params(jmod, 4, jnp.asarray(x))
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    pmod = _load(pswin.DualSwinBlock(dim, heads, hd, mlp, ws,
                                     use_pos_embedding=True), params)
    with torch.no_grad():
        got = to_np(pmod(torch.from_numpy(x)))
    assert _rel(got, want) <= REL_L2


def test_window_that_does_not_divide_the_grid_raises_in_both():
    """A 6x8 grid with window 4: JAX's ``assert h % ws == 0`` fires, the
    port raises ValueError at the same point (the yaml's 256, 384, 640 and
    768 resolutions give Codeformer grids of 8, 12, 20 and 24 against a
    window of 16)."""
    x = np.zeros((1, 6, 8, 16), np.float32)
    jmod = jswin.WindowAttention(16, 2, 8, 4)
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda v: jmod.init(jax.random.PRNGKey(0), v),
                       jnp.asarray(x))
    with pytest.raises(ValueError, match="does not divide"):
        pswin.WindowAttention(16, 2, 8, 4)(torch.from_numpy(x))
    for res in (256, 384, 640, 768):
        assert (res // 32) % 16, res
    for res in (512, 1024):
        assert (res // 32) % 16 == 0, res


@pytest.fixture(scope="module")
def vqgan():
    """The tiny OneDC's VQGAN (hidden 32, the reference's channel_mult and
    codebook) on a seeded 64x64 [0, 1] image: (jax module, params, port
    module, image)."""
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jmod = jvq.MaskGitVQGAN(hidden=32)
    params = _jax_params(jmod, 6, jnp.asarray(x), method=jmod.autoencode)
    return jmod, params, _load(pvq.MaskGitVQGAN(hidden=32), params), x


def test_vqgan_encode_matches_jax(vqgan):
    """The encoder's latents; the quantizer's indices (the agreeing share
    reported), its output (each latent's codebook entry, straight-through)
    and, with JAX's indices, the entries themselves bit for bit."""
    jmod, params, pmod, x = vqgan
    h_want = np.asarray(jax.jit(lambda p, v: jmod.apply(
        p, v, method=lambda m, v: m.encoder(v)))(params, jnp.asarray(x)))
    q_want, i_want = jax.jit(lambda p, v: jmod.apply(p, v))(
        params, jnp.asarray(x))
    q_want, i_want = np.asarray(q_want), np.array(i_want)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        h_got = to_np(pmod.encoder(xt).permute(0, 2, 3, 1))
        q_got, i_got = pmod.encode(xt)
    assert i_got.shape == i_want.shape == (2, 4, 4)
    assert _rel(h_got, h_want) <= DEEP_REL_L2
    agree = float(np.mean(to_np(i_got) == i_want))
    print(f"VQGAN indices agreeing with JAX's: {agree:.4f}")
    assert agree >= INDEX_AGREE
    same = to_np(i_got) == i_want
    assert _rel(to_np(q_got)[same], q_want[same]) <= DEEP_REL_L2
    codebook = pmod.codebook().detach()
    assert torch.equal(
        pmod.quantize.get_codebook_entry(torch.from_numpy(i_want)),
        torch.from_numpy(np.asarray(params["params"]["quantize"]["embedding"])
                         [i_want]))
    assert torch.equal(codebook, torch.from_numpy(
        np.asarray(params["params"]["quantize"]["embedding"])))


def test_vector_quantizer_matches_jax():
    """Indices, straight-through output and its gradient (the identity),
    and the soft code, on latents drawn near the codebook."""
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((64, 8)).astype(np.float32)
    h = (emb[rng.integers(0, 64, (2, 3, 5))]
         + 0.3 * rng.standard_normal((2, 3, 5, 8))).astype(np.float32)
    jmod = jvq.VectorQuantizer(64, 8)
    params = {"params": {"embedding": jnp.asarray(emb)}}
    q_want, i_want = jmod.apply(params, jnp.asarray(h))
    soft_want = jmod.apply(params, jnp.asarray(h), 0.5,
                           method=jmod.get_soft_code)
    pmod = pvq.VectorQuantizer(64, 8)
    with torch.no_grad():
        pmod.embedding.copy_(torch.from_numpy(emb))
    ht = torch.from_numpy(h).requires_grad_()
    q_got, i_got = pmod(ht)
    assert np.array_equal(to_np(i_got), np.asarray(i_want))
    # h + (entry - h), as JAX writes it: the entry up to rounding
    assert np.array_equal(to_np(q_got), np.asarray(q_want))
    assert np.allclose(to_np(q_got), emb[np.asarray(i_want)], atol=1e-6)
    q_got.sum().backward()
    assert torch.equal(ht.grad, torch.ones_like(ht))
    assert _rel(to_np(pmod.get_soft_code(ht, 0.5)),
                np.asarray(soft_want)) <= REL_L2


def test_vqgan_decode_matches_jax(vqgan):
    """``decode`` of JAX's indices (the decoder, its upsample convs and
    the clip to [0, 1]) and ``autoencode``."""
    jmod, params, pmod, x = vqgan
    idx = np.random.default_rng(8).integers(0, 1024, (2, 4, 4))
    want = np.asarray(jax.jit(lambda p, i: jmod.apply(
        p, i, method=jmod.decode))(params, jnp.asarray(idx)))
    with torch.no_grad():
        got = to_np(pmod.decode(torch.from_numpy(idx)).permute(0, 2, 3, 1))
        auto = pmod.autoencode(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert 0.0 <= got.min() and got.max() <= 1.0
    assert _rel(got, want) <= DEEP_REL_L2
    assert auto.shape == (2, 3, 64, 64)


@pytest.fixture(scope="module")
def codeformer():
    """The tiny OneDC's Codeformer (context 64: one head of 64, window 4,
    1024 codes) on a seeded 4x4 y_semantic: (jax module, params, port
    module, y_semantic NHWC)."""
    y = np.random.default_rng(9).standard_normal((2, 4, 4, 64)).astype(
        np.float32)
    jmod = jcf.Codeformer(in_ch=64, codebook_size=1024, window_size=4)
    params = _jax_params(jmod, 10, jnp.asarray(y))
    return jmod, params, _load(pcf.Codeformer(64, 1024, 4), params), y


def test_codeformer_matches_jax(codeformer):
    jmod, params, pmod, y = codeformer
    logits_w, probs_w = jax.jit(jmod.apply)(params, jnp.asarray(y))
    with torch.no_grad():
        logits, probs = pmod(torch.from_numpy(y).permute(0, 3, 1, 2))
    assert logits.shape == probs.shape == (2, 8, 8, 1024)
    assert _rel(to_np(logits), logits_w) <= DEEP_REL_L2
    assert _rel(to_np(probs), probs_w) <= DEEP_REL_L2
    assert np.allclose(to_np(probs).sum(-1), 1.0, atol=1e-5)


def test_codeformer_losses_and_gradients_match_jax():
    """CE against one-hot targets and MSE of ``probs @ codebook``: the
    values, and their gradients with respect to logits, probs and the
    targets' latents."""
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, -1))
    idx = rng.integers(0, 32, (2, 4, 6))
    codebook = rng.standard_normal((32, 8)).astype(np.float32)
    quant = codebook[idx] + 0.1 * rng.standard_normal((2, 4, 6, 8)).astype(
        np.float32)

    def jloss(lg, pr, qt):
        ce, mse = jcf.codeformer_losses(lg, pr, jnp.asarray(idx), qt,
                                        jnp.asarray(codebook))
        return ce + 0.01 * mse, (ce, mse)

    (_, (ce_w, mse_w)), grads_w = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(probs), jnp.asarray(quant))
    ts = [torch.from_numpy(a).requires_grad_() for a in (logits, probs,
                                                          quant)]
    ce, mse = pcf.codeformer_losses(ts[0], ts[1], torch.from_numpy(idx),
                                    ts[2], torch.from_numpy(codebook))
    (ce + 0.01 * mse).backward()
    assert abs(float(ce) - float(ce_w)) <= 1e-6 * abs(float(ce_w))
    assert abs(float(mse) - float(mse_w)) <= 1e-6 * abs(float(mse_w))
    for t, g in zip(ts, grads_w):
        assert _rel(to_np(t.grad), g) <= REL_L2


def test_half_size_resize_is_jax_antialiased_bilinear():
    """``OneDC.vqgan_targets``' resize: ``F.interpolate`` bilinear with
    antialias matches ``jax.image.resize(..., "bilinear")`` (antialias on
    by default); without antialias it is off by about half the range."""
    x = np.random.default_rng(12).uniform(-1, 1, (2, 64, 96, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 32, 48, 3),
                                       method="bilinear"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def resize(antialias):
        return to_np(F.interpolate(xt, size=(32, 48), mode="bilinear",
                                   align_corners=False, antialias=antialias
                                   ).permute(0, 2, 3, 1))
    err = np.abs(resize(True) - want).max()
    off = np.abs(resize(False) - want).max()
    print(f"antialiased resize against JAX: {err:.3e}; without: {off:.3f}")
    assert err <= 1e-6
    assert off > 0.1


def test_codeformer_and_vqgan_porters_match_jax(codeformer, vqgan):
    """``port_codeformer_state`` (its Swin masks skipped, the position
    embedding untransposed) and ``port_vqgan_state`` (the codebook
    untransposed) on reference-named state dicts: the port's tensors equal
    the JAX porter's, read through ``convert_leaf``, bit for bit, and cover
    the port's modules exactly."""
    cases = (("codeformer", codeformer[2], jport.port_codeformer_state,
              pport.port_codeformer_state),
             ("vqgan", vqgan[2], jport.port_vqgan_state,
              pport.port_vqgan_state))
    for kind, module, jax_porter, porter in cases:
        ref = reference_state(module, kind)
        if kind == "codeformer":
            ref["blocks.0.block_sw.attention_block.upper_lower_mask"] = \
                np.zeros((16, 16), np.float32)
        want = dict(convert_leaf(k, v) for k, v in jax_porter(ref).items())
        got = porter(ref)
        assert sorted(got) == sorted(want) == sorted(module.state_dict())
        assert all(np.array_equal(got[k], want[k]) for k in want), kind
