"""The port's metric networks (``onedc_tpu_torch/nn/{lpips,dists,
inception}.py``) and their converters against the JAX package's, on the
CPU, on seeded random weights in the converted layout (the port's numpy
draws, held against ``jax.eval_shape`` of the JAX modules' trees): LPIPS
(avg- and max-pool) with its gradient in the second image against
``jax.grad``, DISTS and ``l2_pool``, the FID InceptionV3 with its resize
from 256 and from 320 to 299; the torch-layout converters bit for bit;
weight files crossing between the packages both ways (the converter CLI
is held in ``test_torch_quality.py``, with the other CLIs)."""

import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread  # noqa: F401  (a fixture)

import jax
import jax.numpy as jnp
from onedc_tpu.nn import dists as jd
from onedc_tpu.nn import inception as ji
from onedc_tpu.nn import lpips as jl
from onedc_tpu.utils.checkpoint import unflatten_params
from onedc_tpu.utils.checkpoint import load_safetensors as jax_load
from onedc_tpu.utils.checkpoint import save_safetensors as jax_save
from onedc_tpu_torch.nn import dists as pd
from onedc_tpu_torch.nn import inception as pi
from onedc_tpu_torch.nn import lpips as pl
from onedc_tpu_torch.utils.safetensors import save_safetensors as port_save

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# f32 distances: the frameworks' convolutions sum in other orders
DIST_ATOL, DIST_RTOL = 1e-5, 1e-4
# features, logits and gradients: relative to the largest reference value
FEAT_TOL = 1e-4


def _max_rel(got, ref) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / np.abs(np.asarray(ref)).max())


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).permute(
        0, 3, 1, 2)


def _images(seed, shape=(2, 64, 48, 3)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = np.clip(x + 0.15 * rng.standard_normal(shape), 0, 1)
    return x, y.astype(np.float32)


def _tree_shapes(tree, prefix=""):
    """{"/"-joined path: shape} of a tree of ``jax.ShapeDtypeStruct``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


@pytest.fixture(scope="module")
def nets():
    """{name: (flat weights, JAX module, port module)}: the port's seeded
    draws in the converted layout, loaded strictly into the port's module
    and given as the JAX module's params, each module built once."""
    x = jnp.zeros((1, 64, 64, 3))
    vgg = pl.random_lpips_weights(0)
    out = {}
    for name, flat, jmod, pmod, args in (
            ("lpips_avg", vgg, jl.LPIPS(True), pl.LPIPS(True), (x, x)),
            ("lpips_max", vgg, jl.LPIPS(False), pl.LPIPS(False), (x, x)),
            ("dists", pd.random_dists_weights(1), jd.DISTS(), pd.DISTS(),
             (x, x)),
            ("inception", pi.random_inception_weights(2, 1008),
             ji.InceptionV3(1008), pi.InceptionV3(1008), (x,))):
        shapes = jax.eval_shape(
            lambda: jmod.init({"params": jax.random.PRNGKey(0)}, *args))
        assert _tree_shapes(shapes["params"]) == {
            k: tuple(v.shape) for k, v in flat.items()}, name
        state = {"lpips": pl.lpips_state_dict, "dists": pd.dists_state_dict,
                 "inception": pi.inception_state_dict}[name.split("_")[0]]
        pmod.load_state_dict(state(flat), strict=True)
        out[name] = (flat, jax.jit(jmod.apply),
                     pmod.eval().requires_grad_(False))
    return out


@pytest.mark.parametrize("pool", ["avg", "max"])
def test_lpips_matches_the_jax_package(nets, pool):
    flat, japply, port = nets[f"lpips_{pool}"]
    x, y = _images(5)
    ref = np.asarray(japply({"params": unflatten_params(flat)}, x, y))
    with torch.no_grad():
        got = port(_nchw(x), _nchw(y)).numpy()
        same = port(_nchw(x), _nchw(x)).numpy()
    assert np.all(ref > 1e-3)
    np.testing.assert_allclose(got, ref, rtol=DIST_RTOL, atol=DIST_ATOL)
    np.testing.assert_array_equal(same, 0.0)


def test_lpips_gradient_matches_jax_grad(nets):
    """d sum(LPIPS(x, y)) / dy, the loss's path to x_hat (avg-pool VGG),
    against ``jax.grad`` in f64, where no ReLU input lies within rounding
    of 0: the port's f64 gradient to 1e-9 of its largest value, its f32
    one in L2 to 1e-3 (in f32 one pre-activation of relu3_3 of this draw
    lies within f32 rounding of 0 and takes the other branch in the port:
    its f32 gradient is 3.5e-4 of the largest value from the f64 one at
    worst, JAX's f32 gradient 1.8e-6)."""
    flat, _, port = nets["lpips_avg"]
    x, y = _images(6)
    with jax.enable_x64(True):
        params = {"params": unflatten_params(
            {k: v.astype(np.float64) for k, v in flat.items()})}
        ref = np.asarray(jax.jit(jax.grad(
            lambda b: jl.LPIPS(True).apply(params, x.astype(np.float64), b)
            .sum()))(y.astype(np.float64)))
    assert ref.dtype == np.float64 and np.abs(ref).max() > 0
    got = {}
    for dtype in (torch.float64, torch.float32):
        yt = torch.from_numpy(y).to(dtype).requires_grad_(True)
        port.to(dtype)(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2),
                       yt.permute(0, 3, 1, 2)).sum().backward()
        got[dtype] = yt.grad.double().numpy()
    assert _max_rel(got[torch.float64], ref) <= 1e-9
    assert np.linalg.norm(got[torch.float32] - ref) <= \
        1e-3 * np.linalg.norm(ref)


def test_dists_and_l2_pool_match_the_jax_package(nets):
    flat, japply, port = nets["dists"]
    x, y = _images(7)
    ref = np.asarray(japply({"params": unflatten_params(flat)}, x, y))
    with torch.no_grad():
        got = port(_nchw(x), _nchw(y)).numpy()
        same = port(_nchw(x), _nchw(x)).numpy()
    assert np.all(ref > 1e-3)
    np.testing.assert_allclose(got, ref, rtol=DIST_RTOL, atol=DIST_ATOL)
    np.testing.assert_allclose(same, 0.0, atol=1e-6)
    for shape in ((2, 17, 24, 5), (1, 64, 48, 3)):
        a = np.random.default_rng(8).uniform(-2, 2, shape).astype(np.float32)
        ref = np.asarray(jax.jit(jd.l2_pool)(a))
        got = pd.l2_pool(_nchw(a)).permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        assert _max_rel(got, ref) <= 1e-6


@pytest.mark.parametrize("size", [256, 320])
def test_inception_matches_the_jax_package(nets, size):
    """Features and logits from uint8-range input at ``size`` squared: the
    bilinear resize to 299 up (256) and down (320), without antialias."""
    flat, japply, port = nets["inception"]
    x = np.random.default_rng(size).uniform(0, 255, (2, size, size, 3))
    feats, logits = japply({"params": unflatten_params(flat)},
                           x.astype(np.float32))
    with torch.no_grad():
        f, lg = port(_nchw(x))
    assert f.shape == (2, 2048) and lg.shape == (2, 1008)
    assert _max_rel(f.numpy(), feats) <= FEAT_TOL
    assert _max_rel(lg.numpy(), logits) <= FEAT_TOL


def test_converters_are_the_jax_packages_bit_for_bit():
    """torch-layout numpy dicts -> the converted layout, each converter
    against its JAX twin: the same keys, dtypes and bits (DISTS with the
    package's 1472-channel alpha / beta and with all 1475)."""
    rng = np.random.default_rng(9)
    vgg = pl.random_vgg16_state(rng)
    lins = [rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
            for c in (64, 128, 256, 512, 512)]
    ab = [rng.uniform(0, 1, (1, n, 1, 1)).astype(np.float32)
          for n in (1472, 1472, 1475, 1475)]
    inc = pi.random_torch_inception(3, num_classes=10)
    pairs = [(jl.convert_torch_vgg16(vgg, lins),
              pl.convert_torch_vgg16(vgg, lins)),
             (jd.convert_torch_dists(vgg, ab[0], ab[1]),
              pd.convert_torch_dists(vgg, ab[0], ab[1])),
             (jd.convert_torch_dists(vgg, ab[2], ab[3]),
              pd.convert_torch_dists(vgg, ab[2], ab[3])),
             (ji.convert_torch_inception(inc),
              pi.convert_torch_inception(inc))]
    for ref, got in pairs:
        assert sorted(ref) == sorted(got)
        for k in ref:
            assert ref[k].dtype == got[k].dtype and \
                np.array_equal(ref[k], got[k]), k
    assert pairs[1][1]["alpha"].shape == (1, 1475)
    np.testing.assert_array_equal(pairs[1][1]["alpha"][0, :3], 0.0)


def test_bn_folding_matches_torch_eval():
    """A conv + eval ``BatchNorm2d`` + ReLU against ``BasicConv`` holding
    the folded weights."""
    gen = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(3, 8, 3, stride=2, bias=False)
    bn = torch.nn.BatchNorm2d(8, eps=1e-3).eval()
    with torch.no_grad():
        for t, lo, hi in ((bn.running_mean, -1, 1), (bn.running_var, 0.5, 2),
                          (bn.weight, 0.5, 1.5), (bn.bias, -1, 1)):
            t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=gen))
        x = torch.randn((2, 3, 17, 17), generator=gen)
        ref = torch.relu(bn(conv(x)))
    state = {"blk.conv.weight": conv.weight.detach().numpy(),
             **{f"blk.bn.{k}": v.detach().numpy()
                for k, v in bn.state_dict().items()
                if k != "num_batches_tracked"},
             "fc.weight": np.zeros((5, 8), np.float32),
             "fc.bias": np.zeros(5, np.float32)}
    flat = pi.convert_torch_inception(state)
    block = pi.BasicConv(3, 8, (3, 3), stride=2)
    block.load_state_dict(pi.inception_state_dict(
        {k[len("blk/"):]: v for k, v in flat.items()
         if k.startswith("blk/")}), strict=True)
    with torch.no_grad():
        torch.testing.assert_close(block(x), ref, atol=2e-5, rtol=0)


def test_weight_files_cross_between_the_packages(nets, tmp_path):
    """A file that the JAX package wrote drives the port's ``make_*_fn``,
    and one that the port wrote, read by the JAX package's reader, its
    modules, to the other's outputs on the same inputs (Inception through
    the port's batched feature function: three patches at a batch of
    two)."""
    x, y = _images(10)
    patches = np.random.default_rng(11).uniform(0, 255, (3, 256, 256, 3))
    patches = patches.astype(np.float32)
    for name, pmake in (
            ("lpips_avg", pl.make_lpips_fn), ("dists", pd.make_dists_fn),
            ("inception", lambda p, device: pi.make_inception_fn(
                p, batch=2, device=device))):
        flat, japply, _ = nets[name]
        jax_path, port_path = tmp_path / f"{name}_jax", tmp_path / name
        jax_save(unflatten_params(flat), jax_path)
        port_save(flat, port_path)
        from_jax = pmake(str(jax_path), device="cpu")
        params = {"params": jax_load(port_path)}
        if name == "inception":
            got = from_jax(patches)
            pad = np.concatenate([patches, np.zeros_like(patches[:1])])
            ref = [japply(params, pad[i:i + 2]) for i in (0, 2)]
            for k, i in (("features", 0), ("logits", 1)):
                want = np.concatenate([np.asarray(r[i]) for r in ref])[:3]
                assert got[k].shape == want.shape
                assert _max_rel(got[k], want) <= FEAT_TOL, k
        else:
            with torch.no_grad():
                got = from_jax(x, y).numpy()
            np.testing.assert_allclose(
                got, np.asarray(japply(params, x, y)), rtol=DIST_RTOL,
                atol=DIST_ATOL)
