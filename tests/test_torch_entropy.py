"""Host bitstream layer of the PyTorch port against the JAX package:
framing, FSQ packing, CDF indexes, the CDF bank and the rANS coder."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onedc_tpu.entropy import framing as jframing
from onedc_tpu.entropy.gaussian import build_cdf_table
from onedc_tpu.entropy.gaussian import build_indexes as jax_build_indexes
from onedc_tpu.nn.fsq import FSQ as JaxFSQ
from onedc_tpu_torch.entropy import framing
from onedc_tpu_torch.entropy.coder import EntropyCoder
from onedc_tpu_torch.entropy.gaussian import (
    LOG_SCALE_MIN,
    LOG_SCALE_STEP,
    build_indexes,
    load_cdf_table,
    scale_bounds,
)
from onedc_tpu_torch.nn.fsq import FSQ
from onedc_tpu_torch.ops import rans

GOLDEN = Path(__file__).parent / "golden" / "rans_golden.npz"
CASES = ("gaussian_1part", "bypass_heavy", "skip_indexes", "tiny_tables",
         "two_parts")


@pytest.mark.parametrize("h,w,caption", [(64, 64, b""), (50, 39, b"cap"),
                                         (768, 512, b"")])
def test_framing_bytes_identical(h, w, caption):
    rng = np.random.default_rng(h * w)
    y = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    _, pr, _, pb = framing.get_padding_size(h, w, 64)
    assert (0, pr, 0, pb) == jframing.get_padding_size(h, w, 64)
    z_len = math.ceil(((h + pb) // 64) * ((w + pr) // 64) * 14 / 8)
    z = rng.integers(0, 256, z_len, dtype=np.uint8).tobytes()
    ours = framing.encode_i(h, w, y, z, caption, len(caption))
    assert ours == jframing.encode_i(h, w, y, z, caption, len(caption))
    a, b = framing.decode_i(ours, 14, 64), jframing.decode_i(ours, 14, 64)
    assert a == b
    with pytest.raises(framing.CorruptBitstreamError):
        framing.decode_i(ours[:-1], 14, 64)


def test_fsq_pack_unpack_and_codes_identical():
    levels = (4,) * 7
    ours, ref = FSQ(levels), JaxFSQ(levels)
    assert ours.index_bits == ref.index_bits == 14
    idx = np.random.default_rng(0).integers(0, 4 ** 7, (1, 3, 5))
    packed = ours.pack_indices(idx)
    assert packed == ref.pack_indices(idx)
    np.testing.assert_array_equal(ours.unpack_indices(packed, 15),
                                  ref.unpack_indices(packed, 15))
    np.testing.assert_array_equal(ours.unpack_indices(packed, 15),
                                  idx.reshape(-1))
    codes = ours.indices_to_codes(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(
        codes, np.asarray(ref.indices_to_codes(jnp.asarray(idx))))


# The JAX package runs build_indexes inside its jitted codec programs, where
# XLA turns the division by LOG_SCALE_STEP into a multiplication by its f32
# reciprocal; eager JAX divides. The jitted form is the one that writes and
# reads streams, so it is the reference here.
_jax_indexes = jax.jit(jax_build_indexes, static_argnums=1)

# f32 scales within this many ulp of exp(LOG_SCALE_MIN + k * LOG_SCALE_STEP)
# hold the JAX package's boundary between index k - 1 and k (it lies at most
# 11 ulp away on the CPU)
BOUNDARY_ULPS = 32


def _boundary_windows():
    k = np.arange(1, 256, dtype=np.float64)
    edges = np.exp(LOG_SCALE_MIN + k * LOG_SCALE_STEP).astype(np.float32)
    offs = np.arange(-BOUNDARY_ULPS, BOUNDARY_ULPS + 1, dtype=np.int32)
    return (edges.view(np.int32)[:, None] + offs).view(np.float32)


@pytest.mark.parametrize("skip", [None, 0.2])
def test_build_indexes_identical_on_random_scales(skip):
    rng = np.random.default_rng(1)
    s = np.exp(rng.uniform(math.log(1e-6), math.log(500.0), 20000))
    s = s.astype(np.float32)
    ours = build_indexes(torch.from_numpy(s), skip).numpy()
    ref = np.asarray(_jax_indexes(jnp.asarray(s), skip))
    np.testing.assert_array_equal(ours, ref)
    # bf16 scales (the serving dtype) index the same as their f32 value
    s16 = torch.from_numpy(s).to(torch.bfloat16)
    np.testing.assert_array_equal(build_indexes(s16, skip).numpy(),
                                  build_indexes(s16.float(), skip).numpy())


def test_build_indexes_near_boundaries():
    """Every f32 scale within BOUNDARY_ULPS of each of the 255 index
    boundaries, and the edge cases, index exactly as in the JAX package."""
    s = np.concatenate([_boundary_windows().reshape(-1), np.float32(
        [0.0, -1.0, 1e-6, 1e-5, 0.11, 64.0, 1e4, np.inf])])
    ours = build_indexes(torch.from_numpy(s)).numpy()
    ref = np.asarray(_jax_indexes(jnp.asarray(s), None))
    flips = np.flatnonzero(ours != ref)
    assert flips.size == 0, (f"{flips.size} CDF-index flips, first at scale "
                             f"{s[flips[:5]]}: port {ours[flips[:5]]}, JAX "
                             f"{ref[flips[:5]]}")


def test_scale_bounds_are_the_jax_step_function():
    """The port's vendored boundary table, derived again: in each window the
    JAX index steps once, from k - 1 to k, and the first scale of index k is
    the table's entry."""
    win = _boundary_windows()
    idx = np.asarray(_jax_indexes(jnp.asarray(win), None))
    k = np.arange(1, 256)[:, None]
    assert ((idx == k - 1) | (idx == k)).all()
    assert (np.diff(idx, axis=1) >= 0).all()
    assert (idx[:, 0] == k[:, 0] - 1).all() and (idx[:, -1] == k[:, 0]).all()
    derived = win[np.arange(255), np.argmax(idx == k, axis=1)]
    np.testing.assert_array_equal(scale_bounds().numpy(), derived)


def test_cdf_bank_equals_jax_vendored_table():
    for ours, ref in zip(load_cdf_table(), build_cdf_table()):
        np.testing.assert_array_equal(ours, ref)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("case", CASES)
def test_coder_golden_streams(golden, case):
    """Decodes each reference-written stream and re-encodes it byte for
    byte."""
    g = {k: golden[f"{case}/{k}"] for k in (
        "cdfs", "sizes", "offsets", "symbols", "indexes", "stream",
        "decoded", "parts")}
    parts = int(g["parts"][0])
    dec = rans.RansDecoder(parts)
    gi = dec.add_cdf(g["cdfs"], g["sizes"], g["offsets"])
    dec.set_stream(g["stream"])
    np.testing.assert_array_equal(dec.decode_stream(g["indexes"], gi),
                                  g["decoded"])
    enc = rans.RansEncoder(parts)
    gi = enc.add_cdf(g["cdfs"], g["sizes"], g["offsets"])
    enc.encode_with_indexes(g["symbols"], g["indexes"], gi)
    enc.flush()
    np.testing.assert_array_equal(enc.get_encoded_stream(), g["stream"])


def test_multi_stream_decode_equals_single():
    cdf = load_cdf_table()
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 256, (3, 500)).astype(np.int16)
    sym = np.round(rng.standard_normal((3, 500)) * 3).astype(np.int16)
    streams = []
    for row in range(3):
        ec = EntropyCoder()
        gi = ec.add_cdf(*cdf)
        ec.encode_with_indexes(sym[row], idx[row], gi)
        ec.flush()
        streams.append(ec.get_encoded_stream())
    coders = []
    for s in streams:
        ec = EntropyCoder()
        gi = ec.add_cdf(*cdf)
        ec.set_stream(s)
        coders.append(ec)
    multi = EntropyCoder.decode_streams(coders, idx, gi)
    np.testing.assert_array_equal(multi, sym)
    with pytest.raises(ValueError):
        coders[0].decode_stream(idx[0], gi + 1)
