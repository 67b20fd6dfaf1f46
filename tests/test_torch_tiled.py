"""The port's tiled codec (``onedc_tpu_torch/parallel/tiled.py``) against
the JAX package's ``TiledCodec`` on the same tiny weights (CPU, f32): the
tile plan and ramp weights equal JAX's exactly, the ``ODTC`` containers
byte for byte (tile 64, overlap 0 on 128x128 and overlap 32 on 96x96, as
``tests/test_tiled.py``), the stitched images within ``IMAGE_TOL``; the
pass-through, the file round trip, and the contract's faults raising
where JAX's raise."""

import json

import numpy as np
import pytest
import torch

from onedc_tpu.parallel import tiled as jtiled
from onedc_tpu_torch.models.onedc import OneDCRuntime
from onedc_tpu_torch.parallel import tiled as ptiled
from torch_golden import runtime_reference
from torch_port_common import (  # noqa: F401  (a fixture)
    IMAGE_TOL,
    one_torch_thread,
    port_model,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def runtimes():
    """The JAX ``TiledCodec``'s outputs on the tests' images (stored by
    ``torch_golden/runtime_reference.py``) and the port's runtime."""
    return (runtime_reference.load("tiled"),
            OneDCRuntime(port_model(), device="cpu"))


def _text(arrays, key) -> str:
    return arrays[key].tobytes().decode()


def _image(h: int, w: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        -1, 1, (1, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("h,w,tile,overlap", [
    (200, 140, 64, 0), (128, 128, 64, 32), (96, 96, 64, 32),
    (64, 64, 64, 0), (40, 128, 64, 0), (130, 700, 64, 16),
    (2160, 3840, 768, 64), (500, 1000, 768, 64), (1080, 1920, 512, 32)])
def test_plan_tiles_matches_jax(h, w, tile, overlap):
    assert ptiled.plan_tiles(h, w, tile, overlap) == \
        jtiled.plan_tiles(h, w, tile, overlap)


@pytest.mark.parametrize("tile,overlap", [(64, 0), (64, 32), (768, 64),
                                          (512, 2)])
def test_ramp_weight_matches_jax(tile, overlap):
    got = ptiled._ramp_weight(tile, overlap)
    want = jtiled._ramp_weight(tile, overlap)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_4k_plan_at_768():
    """The plan the card's 4K check runs: 3 rows and 6 columns."""
    corners = ptiled.plan_tiles(2160, 3840, 768, 64)
    assert sorted({y for y, _ in corners}) == [0, 704, 1392]
    assert sorted({x for _, x in corners}) == [0, 704, 1408, 2112, 2816,
                                               3072]


@pytest.mark.parametrize("size,overlap", [(128, 0), (96, 32)],
                         ids=["128-overlap0", "96-overlap32"])
def test_containers_and_images_match_jax(runtimes, size, overlap, tmp_path):
    gold, prt = runtimes
    image = _image(size, size)
    ptc = ptiled.TiledCodec(prt, tile=64, overlap=overlap)
    # JAX ``TiledCodec(jrt, 64, overlap)``'s encode and decode, stored
    want = runtime_reference.stream(gold, f"tiled{size}")
    want_info = json.loads(_text(gold, f"info{size}"))
    fp = tmp_path / "big.bin"
    got, info = ptc.encode(image, fp=str(fp))
    assert got == want
    assert info == want_info and info["n_tiles"] == 4
    assert fp.read_bytes() == got
    out = ptc.decode(stream=got)
    ref = gold[f"decoded{size}"]
    assert out.shape == (1, size, size, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=IMAGE_TOL)
    # the file round trip decodes the same bits
    assert torch.equal(ptc.decode(fp=str(fp)), out)


def test_stitch_is_decode_batch_where_one_tile_covers(runtimes):
    """Where one tile covers a pixel at weight 1 the stitched image is that
    tile's ``decode_batch`` pixel, bit for bit (the card's check)."""
    _, prt = runtimes
    ptc = ptiled.TiledCodec(prt, tile=64, overlap=16)
    stream, info = ptc.encode(_image(128, 128))
    assert info["n_tiles"] == 9
    out = ptc.decode(stream=stream)[0]
    head, subs = ptiled.split_container(stream)
    assert head == (64, 3, 3, 128, 128) and len(subs) == 9
    tiles = prt.decode_batch(subs)
    weight = ptiled._ramp_weight(64, 16)
    corners = ptiled.plan_tiles(128, 128, 64, 16)
    cover = np.zeros((128, 128), int)
    for ty, tx in corners:
        cover[ty:ty + 64, tx:tx + 64] += 1
    checked = 0
    for (ty, tx), til in zip(corners, tiles):
        mask = (weight == 1) & (cover[ty:ty + 64, tx:tx + 64] == 1)
        checked += int(mask.sum())
        m = torch.from_numpy(mask)
        assert torch.equal(out[ty:ty + 64, tx:tx + 64][m], til[0][m])
    assert checked > 0


def test_small_image_passes_through(runtimes):
    """Both sides at most the tile: the runtime's plain container, the
    JAX pass-through's bytes, decoded by the runtime."""
    gold, prt = runtimes
    image = _image(64, 64)
    ptc = ptiled.TiledCodec(prt, tile=128, overlap=0)
    stream, info = ptc.encode(image)
    direct, direct_info = prt.encode(image)
    assert stream == direct and info == direct_info
    assert not stream.startswith(ptiled.MAGIC)
    assert stream == runtime_reference.stream(gold, "passthrough64")
    assert torch.equal(ptc.decode(stream=stream), prt.decode(direct))


def test_overlap_mismatch(runtimes):
    """The container stores no overlap. A decoder whose overlap plans
    another tile count raises where JAX asserts; one whose plan has the
    encoder's count decodes without a word, as JAX does, blending with
    its own weights (the mis-stitch the format allows)."""
    gold, prt = runtimes
    stream, _ = ptiled.TiledCodec(prt, 64, 0).encode(_image(128, 128))
    # JAX's ``TiledCodec(jrt, 64, 32).decode`` of this container asserts
    assert stream == runtime_reference.stream(gold, "tiled128")
    assert _text(gold, "error128_overlap32") == "AssertionError"
    with pytest.raises(ValueError, match="overlap"):
        ptiled.TiledCodec(prt, 64, 32).decode(stream=stream)

    stream, _ = ptiled.TiledCodec(prt, 64, 32).encode(_image(96, 96))
    right = ptiled.TiledCodec(prt, 64, 32).decode(stream=stream)
    wrong = ptiled.TiledCodec(prt, 64, 0).decode(stream=stream)
    assert stream == runtime_reference.stream(gold, "tiled96")
    ref = gold["decoded96_overlap0"]
    np.testing.assert_allclose(wrong.numpy(), ref, rtol=0, atol=IMAGE_TOL)
    assert not torch.equal(wrong, right)


def test_one_side_small_image_raises_where_jax_raises(runtimes):
    """40x128 at tile 64: corners (0, 0) and (0, 64), tiles of 40x64. Both
    packages encode it (the same bytes); both decodes raise."""
    gold, prt = runtimes
    image = _image(40, 128)
    assert ptiled.plan_tiles(40, 128, 64, 0) == [(0, 0), (0, 64)]
    stream, info = ptiled.TiledCodec(prt, 64, 0).encode(image)
    # JAX ``TiledCodec(jrt, 64, 0)``'s container; its decode raises
    assert stream == runtime_reference.stream(gold, "tiled40x128")
    assert info["n_tiles"] == 2
    assert _text(gold, "error40x128") == "ValueError"
    with pytest.raises(ValueError, match="40x64 tile"):
        ptiled.TiledCodec(prt, 64, 0).decode(stream=stream)


def test_constructor_checks(runtimes):
    _, prt = runtimes
    for tile, overlap in ((100, 0), (64, 3)):
        with pytest.raises(ValueError):
            ptiled.TiledCodec(prt, tile, overlap)
