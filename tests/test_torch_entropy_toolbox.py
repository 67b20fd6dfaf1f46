"""The entropy toolbox of the PyTorch port against the JAX package: the CDF
quantizer, the Laplace family (tables, ``laplace_prob``, indexes, streams),
the factorized prior (``BitEstimator``, ``FactorizedCoder``) and Huffman.
Host numpy and small eager JAX ops only: no JAX compile of a model."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onedc_tpu.entropy import factorized as jfact
from onedc_tpu.entropy import gaussian as jgauss
from onedc_tpu.entropy import huffman as jhuff
from onedc_tpu.entropy.coder import EntropyCoder as JaxEntropyCoder
from onedc_tpu.ops import rans as jrans
from onedc_tpu_torch.entropy import factorized as pfact
from onedc_tpu_torch.entropy import gaussian as pgauss
from onedc_tpu_torch.entropy import huffman as phuff
from onedc_tpu_torch.entropy.coder import EntropyCoder
from onedc_tpu_torch.ops import rans

PROB_TOL = 1e-6
BOUNDARY_ULPS = 32
FAMILIES = ("gaussian", "laplace")


def _table_rows(distribution: str, rows=(0, 40, 128, 255)):
    """pmf rows (f32, the tail bucket last) of the family's table, as
    ``build_cdf_table`` forms them."""
    cdf = {"gaussian": pgauss._normal_cdf,
           "laplace": pgauss._laplace_cdf}[distribution]
    scales = pgauss.scale_table(np.float64, distribution)
    out = []
    for i in rows:
        c = 50
        for j in range(50, 1, -1):
            if cdf(np.float64(j), scales[i]) > 0.9999:
                c = j
        x = np.arange(-c, c + 1, dtype=np.float64)
        pmf = cdf(x + 0.5, scales[i]) - cdf(x - 0.5, scales[i])
        tail = 2.0 * cdf(-c - 0.5, scales[i])
        out.append(np.append(pmf, tail).astype(np.float32))
    return out


def _pmfs(kind: str):
    rng = np.random.default_rng(3)
    if kind == "random":
        return [rng.dirichlet(np.full(n, a)).astype(np.float32)
                for n, a in ((2, 1.0), (17, 0.3), (101, 1.0), (64, 0.05))]
    if kind == "zero_buckets":
        out = []
        for n in (9, 40, 120):
            p = rng.dirichlet(np.ones(n)).astype(np.float32)
            p[rng.choice(n, n // 3, replace=False)] = 0.0
            p[-1] = 1e-7  # a tail far below one quantum
            out.append(p / p.sum())
        out.append(np.zeros(5, np.float32))  # all zero: the total guard
        return out
    return _table_rows(kind)


@pytest.mark.parametrize("kind", ["random", "zero_buckets"] + list(FAMILIES))
@pytest.mark.parametrize("precision", [16, 12])
def test_quantizer_equals_numpy_and_jax(kind, precision):
    for pmf in _pmfs(kind):
        got = rans.pmf_to_quantized_cdf(pmf, precision)
        assert got.dtype == np.uint32 and got.shape == (pmf.size + 1,)
        np.testing.assert_array_equal(
            got, rans.pmf_to_quantized_cdf_np(pmf, precision))
        np.testing.assert_array_equal(
            got, jrans.pmf_to_quantized_cdf(pmf, precision))
        np.testing.assert_array_equal(
            got, jrans.pmf_to_quantized_cdf_np(pmf, precision))
        assert got[-1] == 1 << precision


@pytest.mark.parametrize("distribution", FAMILIES)
@pytest.mark.parametrize("vendored", [True, False])
def test_cdf_tables_equal_jax(distribution, vendored):
    ours = pgauss.build_cdf_table(allow_vendored=vendored,
                                  distribution=distribution)
    ref = jgauss.build_cdf_table(allow_vendored=vendored,
                                 distribution=distribution)
    for a, b in zip(ours, ref):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    if distribution == "gaussian" and vendored:
        for a, b in zip(pgauss.build_gaussian_cdf_table(),
                        pgauss.load_cdf_table()):
            np.testing.assert_array_equal(a, b)


def test_laplace_prob_matches_jax():
    rng = np.random.default_rng(4)
    v = np.round(rng.normal(0, 4, 4000)).astype(np.float32)
    s = np.exp(rng.uniform(math.log(1e-3), math.log(80), 4000))
    s = s.astype(np.float32)
    ours = pgauss.laplace_prob(torch.from_numpy(v), torch.from_numpy(s))
    ref = np.asarray(jgauss.laplace_prob(jnp.asarray(v), jnp.asarray(s)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=PROB_TOL)
    assert (ours.numpy() >= 1e-9).all()


# the jitted form writes and reads the JAX package's streams
_jax_indexes = jax.jit(jgauss.build_indexes, static_argnums=(1, 2))


def _windows(distribution: str):
    lo = math.log(pgauss.DIST_SCALE_MIN[distribution])
    step = (math.log(pgauss.SCALE_MAX) - lo) / (pgauss.SCALE_LEVELS - 1)
    edges = np.exp(lo + np.arange(1, 256) * step).astype(np.float32)
    offs = np.arange(-BOUNDARY_ULPS, BOUNDARY_ULPS + 1, dtype=np.int32)
    return (edges.view(np.int32)[:, None] + offs).view(np.float32)


def test_laplace_scale_bounds_are_the_jax_step_function():
    """The vendored Laplace boundaries, derived again from the jitted JAX
    ``build_indexes(..., "laplace")`` as ``test_torch_entropy.py`` derives
    the Gaussian ones."""
    win = _windows("laplace")
    idx = np.asarray(_jax_indexes(jnp.asarray(win), None, "laplace"))
    k = np.arange(1, 256)[:, None]
    assert ((idx == k - 1) | (idx == k)).all()
    assert (idx[:, 0] == k[:, 0] - 1).all() and (idx[:, -1] == k[:, 0]).all()
    derived = win[np.arange(255), np.argmax(idx == k, axis=1)]
    np.testing.assert_array_equal(
        pgauss.scale_bounds(distribution="laplace").numpy(), derived)


@pytest.mark.parametrize("distribution", FAMILIES)
@pytest.mark.parametrize("skip", [None, 0.2])
def test_indexes_equal_jax(distribution, skip):
    rng = np.random.default_rng(5)
    s = np.exp(rng.uniform(math.log(1e-4), math.log(500.0), 20000))
    s = np.concatenate([s.astype(np.float32), _windows(distribution)[::7]
                        .reshape(-1), np.float32([0, 1e-5, 64, 1e4])])
    ours = pgauss.build_indexes(torch.from_numpy(s), skip, distribution)
    ref = np.asarray(_jax_indexes(jnp.asarray(s), skip, distribution))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown distribution"):
        pgauss.GaussianConditionalCoder("cauchy")


@pytest.mark.parametrize("distribution", FAMILIES)
def test_streams_equal_jax_bytes(distribution):
    """Symbols drawn under scales, coded by the JAX coder of the family and
    by the port's: the same bytes, and the port decodes them exactly."""
    rng = np.random.default_rng(6)
    scales = np.exp(rng.uniform(math.log(0.02), math.log(40), (2, 8, 9, 10)))
    scales = scales.astype(np.float32)
    sym = np.round(rng.laplace(0, scales)).astype(np.float32)
    jc = jgauss.GaussianConditionalCoder(distribution)
    jec = JaxEntropyCoder()
    jc.update(force=True, entropy_coder=jec)
    jc.encode(sym, scales, skip_thres=0.05)
    jec.flush()
    want = jec.get_encoded_stream()

    pc = pgauss.GaussianConditionalCoder(distribution)
    ec = EntropyCoder()
    pc.update(ec)
    idx = pgauss.build_indexes(torch.from_numpy(scales), 0.05,
                               distribution).numpy()
    np.testing.assert_array_equal(idx, jc._indexes_np(scales, 0.05))
    pc.encode_with_indexes(sym, idx)
    ec.flush()
    got = ec.get_encoded_stream()
    assert got == want

    dec = pgauss.GaussianConditionalCoder(distribution)
    dc = EntropyCoder()
    dec.update(dc)
    dc.set_stream(got)
    out = dec.decode_stream_with_indexes(idx)
    assert out.shape == scales.shape
    np.testing.assert_array_equal(out, np.where(idx < 0, 0, sym))


# -- the factorized prior -----------------------------------------------------

CHANNELS = 6


@pytest.fixture(scope="module")
def estimators():
    """The flax BitEstimator with random parameters (init from PRNGKey(1),
    then each leaf scaled up so the four layers do more than pass x
    through) and the port's with the same values."""
    be = jfact.BitEstimator(CHANNELS)
    params = be.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, 1, CHANNELS)))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 0.8, p.shape).astype(np.float32)), params)
    port = pfact.BitEstimator(CHANNELS)
    port.load_state_dict(pfact.state_dict_from_flax(params), strict=True)
    return be, params, port


def test_bit_estimator_matches_jax(estimators):
    be, params, port = estimators
    rng = np.random.default_rng(8)
    x = np.round(rng.normal(0, 6, (2, 5, 7, CHANNELS))).astype(np.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for mode in ("cdf", "logits"):
            np.testing.assert_allclose(
                port(xt, mode=mode).numpy(),
                np.asarray(be.apply(params, jnp.asarray(x), mode=mode)),
                rtol=0, atol=PROB_TOL * (1 if mode == "cdf" else 10))
        for training in (True, False):
            ours = port.bits(xt, training=training).numpy()
            ref = np.asarray(be.bits(params, jnp.asarray(x),
                                     training=training))
            # bits are -log2 of the probabilities: their tolerance is the
            # probabilities' over p ln 2
            p = 2.0 ** -ref
            assert (np.abs(ours - ref) * p * math.log(2) <= PROB_TOL).all()
        np.testing.assert_allclose(
            port.prob(xt).numpy(),
            np.asarray(be.prob(params, jnp.asarray(x))), rtol=0,
            atol=PROB_TOL)
    # the training estimate's gradient reaches the parameters
    port.prob(xt).sum().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in port.parameters())
    port.zero_grad(set_to_none=True)


def test_factorized_coder_matches_jax(estimators):
    """The table as JAX's: the supports and lengths exactly; the quantized
    entries exactly here (an f32 ulp of a CDF could move one, which would
    show as a count here); the streams byte for byte, and both decode."""
    be, params, port = estimators
    jc = jfact.FactorizedCoder(be, params)
    jec = JaxEntropyCoder()
    jc.update(force=True, entropy_coder=jec)
    pc = pfact.FactorizedCoder(port)
    ec = EntropyCoder()
    pc.update(ec)
    q, length, offset = pc.get_cdf_info()
    np.testing.assert_array_equal(length, jc._cdf_length)
    np.testing.assert_array_equal(offset, jc._offset)
    moved = int((q != jc._quantized_cdf).sum())
    assert moved == 0, f"{moved} quantized CDF entries differ from JAX's"

    rng = np.random.default_rng(9)
    z = np.round(rng.normal(0, 3, (1, 6, 5, CHANNELS))).astype(np.int32)
    jec.reset()
    jc.encode(z)
    jec.flush()
    want = jec.get_encoded_stream()
    pc.encode(z)
    ec.flush()
    got = ec.get_encoded_stream()
    assert got == want and len(got) > 0
    dc = EntropyCoder()
    dec = pfact.FactorizedCoder(port)
    dec.update(dc)
    dc.set_stream(got)
    out = dec.decode_stream((6, 5))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out.astype(np.int32), z)


# -- Huffman ------------------------------------------------------------------

@pytest.mark.parametrize("probs", [
    [0.5, 0.25, 0.125, 0.125], [0.25] * 4, [1.0], [0.3, 0.7],
    "dirichlet16", "dirichlet200"])
def test_huffman_tables_and_bytes_equal_jax(probs):
    rng = np.random.default_rng(10)
    if isinstance(probs, str):
        probs = rng.dirichlet(np.full(int(probs[9:]), 0.5))
    probs = list(probs)
    assert phuff.build_code_table(probs) == jhuff.build_code_table(probs)
    ours, ref = phuff.HuffmanCodecOneQP(probs), jhuff.HuffmanCodecOneQP(probs)
    assert ours.max_len == ref.max_len
    for n in (0, 1, 7, 500):
        syms = rng.choice(len(probs), size=n, p=np.asarray(probs) /
                          np.sum(probs))
        data = ours.encode(syms)
        assert data == ref.encode(syms)
        np.testing.assert_array_equal(ours.decode(data), syms)
        np.testing.assert_array_equal(ours.decode(data, count=n // 2),
                                      ref.decode(data, count=n // 2))
    assert ours.decode(b"").shape == (0,)


def test_huffman_multi_qp_equals_jax():
    tables = {0: [0.9, 0.05, 0.05], 3: [0.25, 0.25, 0.5], 7: [1.0]}
    ours, ref = phuff.HuffmanCodec(), jhuff.HuffmanCodec()
    ours.update_vq(tables)
    ref.update_vq(tables)
    for qp, probs in tables.items():
        syms = [i % len(probs) for i in range(11)]
        data = ours.encode(syms, qp)
        assert data == ref.encode(syms, qp)
        np.testing.assert_array_equal(ours.decode(data, qp), syms)
    with pytest.raises(ValueError, match="dangling"):
        # "100" (4 bits of padding), then "1": half of the code "10"
        phuff.HuffmanCodecOneQP([0.5, 0.25, 0.25]).decode(b"\x90")
