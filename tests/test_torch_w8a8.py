"""The port's w8a8 serving mode (``onedc_tpu_torch/nn/quant.py``,
``ops/w8a8.py``) against the JAX package's (``onedc_tpu/nn/quant.py``) on
the same numpy-seeded inputs and weights, on the CPU.

The JAX side runs as ``tests/test_quant.py`` runs it: ``_Q8_MIN_CH`` set to
0 (the tiny widths sit below the 512 gate) and ``QUANT_PREFIXES`` opened
for single modules; the port's gate is ``ONEDC_Q8_MIN_CH``. Limits:

- ``quantize``: q and scale bit-equal; int32 accumulators of every op
  family equal.
- op outputs: within the rounding of the dequantization. XLA's CPU
  backend contracts ``acc * s + bias`` into one fused multiply-add in
  some fusions and not in others (both were measured); the port rounds
  the product and the sum apart, as the JAX source writes them. So an f32
  output may differ by one ulp of the larger of the product and the
  result, and a bf16 output by one bf16 ulp more (``_within_one_ulp``).
- decodes (tiny OneDC, f32): no bit-level limit holds for a whole w8a8
  decode. Any f32 difference before a quantize, even one ulp, can move
  that value to the next int8 level (1/127 of its image's or token's
  range), and over the decode's ~300 quantized ops such steps grow to the
  size of the quantization noise itself. The port against itself shows it:
  a stream decoded in a batch of two (a ulp-level change in the exact ops
  between the quantized ones) lands about as far from its single decode
  (~38 dB PSNR) as the w8a8 image lies from the exact one (~37 dB). So the
  port's w8a8 image is held to JAX's w8a8 image by PSNR, to be no further
  than BATCH_MARGIN_DB below that batch witness, and to the exact image by
  the floors of ``tests/test_quant.py`` (PSNR_FLOOR dB, correlation
  CORR_FLOOR); all three are printed. The bit-level contract is per op
  (above), and the set of ops that quantize equals the JAX interceptor's.
  y_hat and the containers are bit-identical to the exact runtime's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onedc_tpu.nn.quant as jq
from onedc_tpu.models.onedc import OneDC as JaxOneDC
from onedc_tpu.models.onedc import OneDCRuntime as JaxOneDCRuntime
from onedc_tpu.nn.blocks import UpsampleConv2x as JaxUpsampleConv2x
from onedc_tpu.nn.vae import TinyVaeDecoder as JaxTinyVaeDecoder
from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime
from onedc_tpu_torch.nn import blocks, quant
from onedc_tpu_torch.ops import w8a8
from onedc_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_common import (  # noqa: F401  (a fixture)
    TINY,
    fill_params,
    one_torch_thread,
    port_model,
    seeded_images,
    tiny_jax_model,
)

BATCH_MARGIN_DB = 3.0
PSNR_FLOOR = 25.0
CORR_FLOOR = 0.99

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _q8_all_channels(monkeypatch):
    """Both gates at 0: the tiny widths (32-64) sit below 512."""
    monkeypatch.setattr(jq, "_Q8_MIN_CH", 0)
    monkeypatch.setenv("ONEDC_Q8_MIN_CH", "0")


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(4.0 / max(mse, 1e-12))


# -- quantize and the ops ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_is_bit_equal_to_jax(dtype):
    """q and scale of ``quantize`` equal ``_quantize``'s per image, per
    token and per tensor; the input has exact .5 ties (image 0's scale is
    1.0) and an all-zero image (the 1e-12 floor)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 6, 16)).astype(np.float32) * 9
    x[0, 0, 0, :6] = [127.0, 0.5, 1.5, -2.5, 62.5, -0.5]
    x[0] = np.clip(x[0], -127, 127)
    x[1] = 0.0
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    for jax_axes, port_x, port_dims, to_jax in (
            ((1, 2, 3), xt.permute(0, 3, 1, 2), (1, 2, 3),
             lambda t: t.permute(0, 2, 3, 1)),
            ((3,), xt, (3,), lambda t: t),
            (None, xt, None, lambda t: t)):
        qj, sj = jax.jit(lambda a, _ax=jax_axes: jq._quantize(a, _ax))(xj)
        qt, st = w8a8.quantize(port_x, port_dims)
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(to_jax(qt).numpy(), np.asarray(qj))
        np.testing.assert_array_equal(
            to_jax(st).numpy().reshape(np.shape(sj)), np.asarray(sj))
    assert (qt.numpy()[0, 0, 0, 1:6] == [0, 2, -2, 62, 0]).all()


def _jax_module(kind: str, cout: int):
    import flax.linen as fnn

    class M(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            if kind == "upsample":
                return JaxUpsampleConv2x(cout, name="op")(x)
            if kind.startswith("dense"):
                return fnn.Dense(cout, name="op")(x)
            k, s = {"conv3x3": (3, 1), "conv3x3_s2": (3, 2),
                    "conv1x1": (1, 1)}[kind]
            return fnn.Conv(cout, (k, k), strides=(s, s),
                            padding=(k - 1) // 2, name="op")(x)
    return M()


OP_SHAPES = {"conv3x3": (2, 9, 10, 16), "conv3x3_s2": (2, 9, 10, 16),
             "conv1x1": (2, 9, 10, 16), "dense2d": (3, 40),
             "dense3d": (2, 7, 40), "upsample": (2, 5, 7, 16)}


def _jax_accumulators(kind, xj, kernel):
    """JAX's int32 accumulators on its own int8 operands (NHWC out)."""
    k32 = kernel.astype(jnp.float32)
    if kind.startswith("dense"):
        xq, _ = jq._quantize(xj, axes=(xj.ndim - 1,))
        kq, _ = jq._quantize(k32, axes=(0,))
        return jax.lax.dot_general(xq, kq, (((xj.ndim - 1,), (0,)),
                                            ((), ())),
                                   preferred_element_type=jnp.int32)
    xq, _ = jq._quantize(xj, axes=(1, 2, 3))
    if kind == "upsample":
        k32 = (jnp.pad(k32, ((0, 1), (0, 1), (0, 0), (0, 0)))
               + jnp.pad(k32, ((1, 0), (0, 1), (0, 0), (0, 0)))
               + jnp.pad(k32, ((0, 1), (1, 0), (0, 0), (0, 0)))
               + jnp.pad(k32, ((1, 0), (1, 0), (0, 0), (0, 0))))
        strides, pad, dil = (1, 1), ((2, 2), (2, 2)), (2, 2)
    else:
        s = 2 if kind == "conv3x3_s2" else 1
        p = 0 if kind == "conv1x1" else 1
        strides, pad, dil = (s, s), ((p, p), (p, p)), None
    kq, _ = jq._quantize(k32, axes=(0, 1, 2))
    return jax.lax.conv_general_dilated(
        xq, kq, strides, pad, lhs_dilation=dil,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)


def _port_accumulators(kind, xt, weight):
    """The port's int32 accumulators (NHWC out) for NCHW / (..., K) xt."""
    if kind.startswith("dense"):
        xq, _ = w8a8.quantize(xt, (xt.dim() - 1,))
        wq, _ = w8a8.quantize(weight.float(), (1,))
        return w8a8.int8_matmul(xq.reshape(-1, xt.shape[-1]), wq).view(
            *xt.shape[:-1], -1)
    xq, _ = w8a8.quantize(xt, (1, 2, 3))
    xq = xq.permute(0, 2, 3, 1)
    if kind == "upsample":
        k4q, _ = w8a8.quantize(w8a8.upsample_kernel4(weight), (1, 2, 3))
        xp = torch.nn.functional.pad(xq, (0, 0, 1, 1, 1, 1))
        b, h, w, _ = xq.shape
        acc = torch.stack([torch.stack([w8a8.upsample_phase(xp, k4q, py, px)
                                        for px in (0, 1)], dim=3)
                           for py in (0, 1)], dim=2)
        return acc.reshape(b, 2 * h, 2 * w, -1)
    wq, _ = w8a8.quantize(weight.float(), (1, 2, 3))
    s = 2 if kind == "conv3x3_s2" else 1
    return w8a8.conv_acc(xq, wq, s, 0 if kind == "conv1x1" else 1)


def _ulp(v, mantissa_bits: int):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))
                   - mantissa_bits)


def _within_one_ulp(got: np.ndarray, want: np.ndarray, bias: np.ndarray,
                    dtype: str) -> float:
    """|got - want| within the rounding of the dequantization: one f32 ulp
    of the larger of the result and the product ``acc * s`` (= want -
    bias; a fused multiply-add skips the product's rounding), plus, in
    bf16, one bf16 ulp of the result. Returns the share that differs."""
    tol = _ulp(np.maximum(np.abs(want), np.abs(want - bias)), 23)
    if dtype == "bfloat16":
        tol = tol + _ulp(want, 7)
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (np.abs(got - want).max(), bad.mean())
    return float((got != want).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(OP_SHAPES))
def test_op_matches_jax(kind, dtype, monkeypatch):
    """Each op family against the JAX module under ``w8a8_methods()``
    (``QUANT_PREFIXES`` opened as ``tests/test_quant.py`` does): int32
    accumulators equal, outputs within one ulp."""
    monkeypatch.setattr(jq, "QUANT_PREFIXES", ((),))
    rng = np.random.default_rng(sorted(OP_SHAPES).index(kind))
    x = rng.standard_normal(OP_SHAPES[kind]).astype(np.float32)
    m = _jax_module(kind, 24)
    params = fill_params(jax.eval_shape(m.init, jax.random.PRNGKey(0), x),
                         rng)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype),
                                    params)
    xj = jnp.asarray(x).astype(dtype)

    def apply(p, a):
        with jq.w8a8_methods():
            return m.apply(p, a)
    want = np.asarray(jax.jit(apply)(params, xj).astype(jnp.float32))
    kernel = params["params"]["op"]["kernel"]
    bias = params["params"]["op"]["bias"]
    want_acc = np.asarray(jax.jit(_jax_accumulators, static_argnums=0)(
        kind, xj, kernel))

    tdt = getattr(torch, dtype)
    k = torch.from_numpy(np.array(kernel.astype(jnp.float32)))
    weight = (k.t() if kind.startswith("dense") else
              k.permute(3, 2, 0, 1)).contiguous().to(tdt)
    b = torch.from_numpy(np.array(bias.astype(jnp.float32))).to(tdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    if kind.startswith("dense"):
        got = w8a8.w8a8_dense(xt, weight, b)
    else:
        xt = xt.permute(0, 3, 1, 2)
        if kind == "upsample":
            got = w8a8.w8a8_upsample(xt, weight, b)
        else:
            s = 2 if kind == "conv3x3_s2" else 1
            got = w8a8.w8a8_conv(xt, weight, b, s,
                                 0 if kind == "conv1x1" else 1)
        got = got.permute(0, 2, 3, 1)
    acc = _port_accumulators(kind, xt, weight)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    share = _within_one_ulp(got.float().numpy(), want,
                            np.asarray(bias.astype(jnp.float32)), dtype)
    print(f"{kind} {dtype}: {share:.2%} of the outputs one ulp apart")


@pytest.mark.parametrize("which", ["conv", "dense", "upsample"])
def test_operators_pass_opcheck(which):
    """The three operators that exported programs record: schema, fake
    implementation and strides as ``torch.library.opcheck`` checks them."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 5, 6, generator=gen)
    b = torch.randn(12, generator=gen)
    if which == "conv":
        w = torch.randn(12, 8, 3, 3, generator=gen)
        torch.library.opcheck(w8a8.w8a8_conv, (x, w, b, 2, 1))
        torch.library.opcheck(w8a8.w8a8_conv, (x.bfloat16(), w.bfloat16(),
                                               None, 1, 1))
    elif which == "dense":
        w = torch.randn(12, 6, generator=gen)
        torch.library.opcheck(w8a8.w8a8_dense, (x, w, b))
    else:
        w = torch.randn(12, 8, 3, 3, generator=gen)
        torch.library.opcheck(w8a8.w8a8_upsample, (x, w, None))


def test_int8_matmul_pads_to_the_cards_shapes():
    """The card's route (``torch._int_mm`` needs M > 16 and K, N multiples
    of 8) pads and trims exactly: on CPU tensors, where ``torch._int_mm``
    takes any shape, it equals the plain float64 product, and it counts
    its launches."""
    gen = torch.Generator().manual_seed(2)
    before = w8a8.launches
    for m, k, n in ((1, 12, 5), (3, 1280, 1280), (40, 16, 24)):
        a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
        got = w8a8.int8_matmul_cuda(a, w)
        assert got.shape == (m, n) and got.dtype == torch.int32
        assert torch.equal(got, w8a8.int8_matmul_plain(a, w))
    assert w8a8.launches - before == 3
    with pytest.raises(TypeError):
        w8a8.int8_matmul(a.float(), w)


# -- the gate and the scope -------------------------------------------------

class _Pair(torch.nn.Module):
    """A 320 -> 64 -> 320 pair of 3x3 convs under ``unet.``."""

    def __init__(self):
        super().__init__()
        self.unet = torch.nn.Sequential(blocks.conv3x3(320, 64),
                                        blocks.conv3x3(64, 320))


@pytest.mark.parametrize("gate,quantized", [(320, 0), (64, 2)])
def test_gate_skips_narrow_ops(monkeypatch, gate, quantized):
    """The mirror of ``test_roofline_gate_skips_narrow_ops``: each conv of
    the pair is narrow on one side, so at gate 320 neither quantizes and
    the scope's output is the exact one; at gate 64 both do."""
    monkeypatch.setenv("ONEDC_Q8_MIN_CH", str(gate))
    pair = _Pair()
    x = torch.randn(1, 320, 8, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), quant.recording() as ops, \
            quant.w8a8_scope(quant.w8a8_table(pair)):
        got = pair.unet(x)
    assert [o.path for o in ops] == ["unet.0", "unet.1"][:quantized]
    with torch.no_grad():
        exact = pair.unet(x)
    assert torch.equal(got, exact) == (quantized == 0)


def _jax_quantized_ops(jm, method, args):
    """(path, rule, Cin, Cout) of every op the JAX interceptor quantizes in
    ``method`` of the flax model ``jm`` (traced by ``jax.eval_shape``)."""
    rec = []

    def recording(rule, fn):
        def f(mod, x):
            rec.append(("/".join(mod.path), rule, int(x.shape[-1]),
                        int(mod.features)))
            return fn(mod, x)
        return f

    def init(*a):
        with jq.w8a8_methods():
            return jm.init({"params": jax.random.PRNGKey(0)}, *a,
                           method=getattr(jm, method))
    with pytest.MonkeyPatch.context() as mp:
        for rule in ("conv", "dense", "upsample"):
            name = f"_{rule}_w8a8"
            mp.setattr(jq, name, recording(rule, getattr(jq, name)))
        jax.eval_shape(init, *args)
    return sorted(rec)


@pytest.mark.parametrize("geometry,vae,gate", [
    ("tiny", "large", 0), ("tiny", "tiny", 0), ("full", "large", 512)])
def test_quantized_ops_are_the_jax_interceptors(geometry, vae, gate,
                                                monkeypatch):
    """The (module path, rule, Cin, Cout) of every op that the port's
    decode quantizes equal the JAX interceptor's, call for call: at the
    tiny geometry with gate 0 (the large VAE's decode and the TinyVAE's),
    and at full width with the default gate 512 (the port on the meta
    device). The VAE resnets' convs (K2's weights) are in neither."""
    monkeypatch.setattr(jq, "_Q8_MIN_CH", gate)
    monkeypatch.setenv("ONEDC_Q8_MIN_CH", str(gate))
    cfg = dict(TINY) if geometry == "tiny" else {}
    cfg["use_large_vae"] = vae == "large"
    device = "cpu" if geometry == "tiny" else "meta"
    with torch.device(device):
        model = OneDC(**cfg)
    c = model.codec.y_spatial_prior_reduction.out_channels
    s = model.codec.hyper_dec.feat_in.out_channels
    y_hat = torch.zeros((1, 4, 4, c), device=device)
    z_sem = torch.zeros((1, 1, 1, s), device=device)
    with torch.no_grad(), quant.recording() as ops, \
            quant.w8a8_scope(quant.w8a8_table(model)):
        model.decode_device_vae(model.decode_device_x0(y_hat, z_sem))
    got = sorted((o.path.replace(".", "/"), o.rule, o.cin, o.cout)
                 for o in ops)
    jm = JaxOneDC(**cfg)
    want = _jax_quantized_ops(jm, "decode_device", (
        jax.ShapeDtypeStruct((1, 4, 4, c), jnp.float32),
        jax.ShapeDtypeStruct((1, 1, 1, s), jnp.float32)))
    assert got == want
    assert got and not any("resnets" in p and p.endswith(("conv1", "conv2"))
                           and p.startswith("vae/") for p, *_ in got)
    families = {o.family for o in ops}
    if (geometry, vae) == ("tiny", "large") or geometry == "full":
        assert families == {"conv3x3", "conv3x3_s2", "conv1x1", "upsample",
                            "dense", "time_dense"}


def test_batch_rows_quantize_alone():
    """Per-image conv and per-token dense scales: row 0 of a batch whose
    row 1 is 100x larger gives its B=1 output bit for bit, in each rule
    (the mirror of ``test_w8a8_batch_invariance``; the port's int32 sums
    are exact, so the bits agree, not only the values)."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, 8, 8, generator=gen)
    x[1] *= 100.0
    holder = torch.nn.Module()
    holder.unet = torch.nn.ModuleDict({
        "conv": blocks.conv3x3(16, 32), "dense": blocks.Linear(8, 16),
        "up": blocks.UpsampleConv2x(16, 8)})
    with torch.no_grad(), quant.recording() as ops, \
            quant.w8a8_scope(quant.w8a8_table(holder)):
        for m in holder.unet.values():
            assert torch.equal(m(x)[:1], m(x[:1]))
    assert sorted(o.rule for o in ops) == ["conv"] * 2 + ["dense"] * 2 + [
        "upsample"] * 2


# -- the runtime: decodes, containers, the CLI's mode -----------------------

def _tiny_vae_params(jm, params):
    """``params`` with a seeded ``vae_tiny_dec`` subtree (the JAX
    ``ensure_tiny_vae_params`` grafts a random init there)."""
    tv = JaxTinyVaeDecoder(ch=jm.tiny_vae_ch)
    sub = fill_params(jax.eval_shape(tv.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8, 8, jm.vae_ch))),
                      np.random.default_rng(11))["params"]
    return {**params, "vae_tiny_dec": sub}


def _images():
    """The two seeded test images and a noisy copy of the first: three
    streams of the 64x64 bucket."""
    ims = seeded_images()
    rng = np.random.default_rng(3)
    return ims + [np.clip(ims[0] + 0.1 * rng.standard_normal(ims[0].shape),
                          -1, 1).astype(np.float32)]


@pytest.fixture(scope="module")
def jax_w8a8():
    """The JAX package's w8a8 runtimes (f32, gate 0 while they trace):
    the streams its encode writes of ``_images()`` and its w8a8 decode of
    each; the TinyVAE runtime's decode of the first; the z-only decode of
    the port's z indices of the first image (``port_w8a8`` fills them)."""
    jm, params = tiny_jax_model()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "_Q8_MIN_CH", 0)
        rt = JaxOneDCRuntime(jm, params, quant="w8a8")
        rt.update(force=True)
        streams = [bytes(rt.encode(jnp.asarray(im))[0]) for im in _images()]
        out["streams"] = streams
        out["large"] = [np.asarray(rt.decode(stream=s)) for s in streams]
        tiny = JaxOneDCRuntime(jm, {"params": _tiny_vae_params(
            jm, params["params"] if "params" in params else params)},
            quant="w8a8", vae="tiny")
        tiny.update(force=True)
        out["tiny"] = np.asarray(tiny.decode(stream=streams[0]))
        out["z_rt"] = JaxOneDCRuntime(jm.clone(z_only=True), params,
                                      quant="w8a8")
    return out


@pytest.fixture(scope="module")
def port_w8a8():
    """Exact and w8a8 port runtimes (f32) on one model, and the same for
    the TinyVAE and the z-only model."""
    model = port_model()
    tiny = OneDC(**TINY, use_large_vae=False)
    jm, params = tiny_jax_model()
    flat = params["params"] if "params" in params else params
    tiny.load_state_dict(state_dict_from_jax(_tiny_vae_params(jm, flat)),
                         strict=True)
    z_model = port_model(z_only=True)
    return {"exact": OneDCRuntime(model, device="cpu"),
            "w8a8": OneDCRuntime(model, device="cpu", quant="w8a8"),
            "tiny_exact": OneDCRuntime(tiny, device="cpu"),
            "tiny": OneDCRuntime(tiny, device="cpu", quant="w8a8"),
            "z_exact": OneDCRuntime(z_model, device="cpu"),
            "z": OneDCRuntime(z_model, device="cpu", quant="w8a8")}


def _check_image(got, want_w8a8, exact, to_batch, what):
    """PSNR of the port's w8a8 image ``got`` against JAX's w8a8 image, no
    more than BATCH_MARGIN_DB below ``to_batch`` (PSNR of a stream decoded
    by the port beside another against its single decode); against the
    exact image, the floors of ``tests/test_quant.py``."""
    got, want_w8a8, exact = (np.asarray(a, np.float32) for a in (
        got, want_w8a8, exact))
    assert got.shape == want_w8a8.shape == exact.shape
    to_jax, to_exact = _psnr(got, want_w8a8), _psnr(got, exact)
    corr = np.corrcoef(got.ravel(), exact.ravel())[0, 1]
    print(f"{what}: PSNR to JAX's w8a8 image {to_jax:.2f} dB (max "
          f"{np.abs(got - want_w8a8).max():.3f}), to the port's batched "
          f"decode {to_batch:.2f} dB, to the exact image {to_exact:.2f} dB "
          f"(max {np.abs(got - exact).max():.3f}, correlation {corr:.5f})")
    assert to_jax >= to_batch - BATCH_MARGIN_DB, what
    assert to_jax > PSNR_FLOOR, what
    assert to_exact > PSNR_FLOOR and corr > CORR_FLOOR, what


@pytest.mark.parametrize("which", ["large", "tiny", "z_only", "pipelined"])
def test_w8a8_decode_matches_jax(jax_w8a8, port_w8a8, which):
    """The port's w8a8 decode of JAX-written streams against the JAX
    package's w8a8 decode and its own exact decode (``_check_image``);
    y_hat bit-identical to the exact runtime's. The large VAE, the
    TinyVAE, the z-only model, and the pipelined ``decode_batch`` of three
    streams (chunks of two) against JAX's single decodes."""
    streams = jax_w8a8["streams"]
    if which == "z_only":
        exact_rt, rt = port_w8a8["z_exact"], port_w8a8["z"]
        ims = _images()
        z = exact_rt.write_plan(np.concatenate([ims[0], ims[2]]))[
            "z_indices"]
        want = np.asarray(jax_w8a8["z_rt"]._decode_z_only(
            jax_w8a8["z_rt"].params, jnp.asarray(z[:1].numpy())))
        with torch.no_grad():
            both = rt.quantized(rt.model.decode_device_z_only)(z)
            got = rt.quantized(rt.model.decode_device_z_only)(z[:1])
            exact = exact_rt.model.decode_device_z_only(z[:1])
        _check_image(got.permute(0, 2, 3, 1), want, exact.permute(0, 2, 3, 1),
                     _psnr(both[:1], got), which)
        return
    if which == "pipelined":
        exact_rt, rt = port_w8a8["exact"], port_w8a8["w8a8"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ONEDC_PIPELINE_CHUNK", "2")
            got = rt.decode_batch(streams)
            exact = exact_rt.decode_batch(streams)
        singles = [rt.decode(s) for s in streams]
        assert torch.equal(got[2], singles[2])  # a chunk of one
        to_batch = min(_psnr(got[i], singles[i]) for i in (0, 1))
        for i, want in enumerate(jax_w8a8["large"]):
            _check_image(got[i], want, exact[i], to_batch, f"pipelined[{i}]")
        return
    exact_rt, rt = ((port_w8a8["exact"], port_w8a8["w8a8"]) if which ==
                    "large" else (port_w8a8["tiny_exact"], port_w8a8["tiny"]))
    trace, trace_exact = {}, {}
    got = rt.decode(streams[0], trace)
    exact = exact_rt.decode(streams[0], trace_exact)
    assert torch.equal(trace["y_hat"], trace_exact["y_hat"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ONEDC_PIPELINE_CHUNK", "2")
        batched = rt.decode_batch(streams[::2])[0]
    _check_image(got, jax_w8a8[which] if which == "tiny"
                 else jax_w8a8["large"][0], exact, _psnr(batched, got), which)


def test_w8a8_containers_are_the_exact_runtimes(jax_w8a8, port_w8a8):
    """Encode never quantizes: the w8a8 runtime writes the exact runtime's
    containers and JAX's w8a8 runtime's (lambda model), and the z-only
    w8a8 runtime the exact z-only runtime's."""
    for im, want in zip(_images(), jax_w8a8["streams"]):
        assert port_w8a8["w8a8"].encode(im)[0] == want
        assert port_w8a8["exact"].encode(im)[0] == want
    im = _images()[0]
    assert port_w8a8["z"].encode(im) == port_w8a8["z_exact"].encode(im)


def test_set_params_reaches_the_quantized_ops(port_w8a8):
    """Weights are quantized per call: after ``set_params`` the w8a8
    runtime decodes as a fresh w8a8 runtime on the new weights."""
    rt = port_w8a8["w8a8"]
    base = {k: v.clone() for k, v in rt.model.state_dict().items()}
    stream = port_w8a8["exact"].encode(_images()[0])[0]
    before = rt.decode(stream)
    moved = dict(base)
    for k in [k for k in base if k.startswith("unet.up_blocks_1.resnets_0")
              and k.endswith("weight")]:
        moved[k] = base[k] * 1.5
    rt.set_params(moved)
    try:
        after = rt.decode(stream)
        fresh = OneDCRuntime(port_model(), state=moved, device="cpu",
                             quant="w8a8").decode(stream)
    finally:
        rt.set_params(base)
    assert torch.equal(after, fresh) and not torch.equal(after, before)


def test_upsample_switch_keeps_the_upsample_exact(monkeypatch):
    """``ONEDC_Q8_UPSAMPLE=0`` (JAX ``_Q8_UPSAMPLE``) leaves the upsample
    convs exact and quantizes the rest."""
    monkeypatch.setenv("ONEDC_Q8_UPSAMPLE", "0")
    holder = torch.nn.Module()
    holder.unet = torch.nn.ModuleDict({"up": blocks.UpsampleConv2x(8, 8),
                                       "conv": blocks.conv3x3(8, 8)})
    x = torch.randn(1, 8, 4, 4, generator=torch.Generator().manual_seed(5))
    with torch.no_grad(), quant.recording() as ops, \
            quant.w8a8_scope(quant.w8a8_table(holder)):
        up = holder.unet["up"](x)
        holder.unet["conv"](x)
    assert [o.rule for o in ops] == ["conv"]
    with torch.no_grad():
        assert torch.equal(up, holder.unet["up"](x))


def test_unknown_quant_mode_raises():
    with pytest.raises(ValueError, match="unknown quant mode"):
        OneDCRuntime(port_model(), device="cpu", quant="w4a4")
