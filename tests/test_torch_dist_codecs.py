"""The batch codecs over a ``data`` axis of two and the spatially split
decode over a ``tensor`` axis of two, on two gloo processes on the CPU
(``onedc_tpu_torch/parallel/{mesh,spatial,tiled}.py``, the ``mesh=`` of
``models/onedc.py``), against one process and the JAX package's stored
containers (``torch_golden/spatial.npz``, ``decode.npz``, ``tiled.npz``;
``runtime_reference.py`` writes them).

Tolerances: the spatial decode within the JAX package's own 2e-4
(``tests/test_spatial.py:52``); a data-parallel decode within BATCH_TOL of
one process's (a rank decodes another batch of rows than one process does,
and CPU convs round a batch's rows by its size)."""

import numpy as np
import pytest
import torch

import torch_dist
from onedc_tpu_torch.models.onedc import OneDCRuntime
from onedc_tpu_torch.parallel.tiled import TiledCodec
from torch_golden import runtime_reference
from torch_port_common import (  # noqa: F401  (a fixture)
    IMAGE_TOL,
    one_torch_thread,
    port_model,
    spatial_images,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPATIAL_TOL = 2e-4
BATCH_TOL = 1e-4
TILE, OVERLAP = 64, 32


def _tiled_image():
    # test_torch_tiled.py's 96x96 image, whose container tiled.npz stores
    return np.random.default_rng(3).uniform(-1, 1, (1, 96, 96, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(stored JAX arrays, the one-process results, rank 0's and rank 1's
    results of ``torch_dist.codecs``)."""
    root = tmp_path_factory.mktemp("dist_codecs")
    gold = runtime_reference.load("spatial")
    small = runtime_reference.stream(runtime_reference.load("decode"),
                                     "stream0")
    streams = [runtime_reference.stream(gold, f"lambda{i}") for i in (0, 1)]
    z_streams = [runtime_reference.stream(gold, f"z_only{i}")
                 for i in (0, 1)]
    torch.save(port_model().state_dict(), root / "state.pt")
    rt = OneDCRuntime(port_model(), device="cpu")
    rtz = OneDCRuntime(port_model(z_only=True), device="cpu")
    images = spatial_images()
    tiled = TiledCodec(rt, TILE, OVERLAP)
    one = dict(
        decode=[rt.decode(s).numpy() for s in streams],
        decode_z=[rtz.decode(s).numpy() for s in z_streams],
        decode_batch=[t.numpy() for t in rt.decode_batch(
            streams + [small, streams[0]])],
        tiled_decoded=tiled.decode(stream=runtime_reference.stream(
            runtime_reference.load("tiled"), "tiled96")).numpy())
    two = torch_dist.spawn(torch_dist.codecs, 2, root / "spawn",
                           str(root / "state.pt"), images, streams, z_streams,
                           small, _tiled_image(), TILE, OVERLAP)
    return gold, one, two


@pytest.mark.parametrize("kind", ["lambda", "z_only"])
def test_spatial_decode_matches_the_single_decode(runs, kind):
    """The JAX-written 128x128 streams decoded split over two bands (the
    lambda model through ``decode`` and the pipelined ``decode_batch``, the
    z-only model through its program) within 2e-4 of the port's single
    decode, on both ranks (each returns the whole image); the single decode
    itself within IMAGE_TOL of JAX's."""
    gold, one, two = runs
    want = one["decode"] if kind == "lambda" else one["decode_z"]
    for i, w in enumerate(want):
        np.testing.assert_allclose(w, gold[f"{kind}{i}_decoded"], rtol=0,
                                   atol=IMAGE_TOL)
    for r in two:
        got = r["spatial"] if kind == "lambda" else r["spatial_z"]
        for g, w in zip(got, want):
            assert g.shape == w.shape == (1, 128, 128, 3)
            np.testing.assert_allclose(g, w, rtol=SPATIAL_TOL,
                                       atol=SPATIAL_TOL)
        if kind == "lambda":
            for g, w in zip(r["spatial_batch"], want):
                np.testing.assert_allclose(g, w, rtol=SPATIAL_TOL,
                                           atol=SPATIAL_TOL)
            # the convs of the bands took halos: the UNet's levels (8, 4,
            # 2, 1 rows) and the VAE's (8 latent rows up to 64 image rows)
            assert r["halos"] > 0
            assert r["band_rows"] == [1, 2, 4, 8, 16, 32, 64]


def test_spatial_split_that_does_not_divide_raises(runs):
    """A 64x64 image's 8 latent rows over two bands leave half a row at the
    tiny UNet's deepest level: ValueError, where GSPMD would pad."""
    _, _, two = runs
    for r in two:
        assert "multiples of 16" in r["small_error"]


def test_data_parallel_encodes_write_the_jax_containers(runs):
    """``encode_batch`` and ``encode_many`` of three images over two data
    ranks (rank 1's second row is padding): the JAX package's containers
    byte for byte, in input order, on both ranks."""
    gold, _, two = runs
    want = [runtime_reference.stream(gold, f"lambda{i}") for i in (0, 1, 0)]
    for r in two:
        assert r["encode_batch"] == want
        assert r["encode_many"] == want


def test_data_parallel_decode_batch_matches_one_process(runs):
    """``decode_batch`` of four streams in two buckets (128x128 three, one
    of them twice, and 64x64 one) over two data ranks: every image, on both
    ranks, within BATCH_TOL of one process's."""
    _, one, two = runs
    for r in two:
        assert len(r["decode_batch"]) == 4
        for g, w in zip(r["decode_batch"], one["decode_batch"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=BATCH_TOL)


def test_data_parallel_tiled_codec(runs):
    """``TiledCodec(..., mesh=)`` on 96x96 at tile 64, overlap 32: JAX's
    ``ODTC`` container byte for byte, and its decode within BATCH_TOL of
    one process's."""
    _, one, two = runs
    want = runtime_reference.stream(runtime_reference.load("tiled"),
                                    "tiled96")
    for r in two:
        assert r["tiled"] == want
        np.testing.assert_allclose(r["tiled_decoded"], one["tiled_decoded"],
                                   rtol=0, atol=BATCH_TOL)
