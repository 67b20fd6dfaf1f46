"""The z-only (extreme-low-bpp) model against the JAX package's
``OneDC(z_only=True)`` on the same weights (tiny geometry, f32, CPU).

Its container carries the 14-bit z indices and no y stream: the port must
write the JAX package's bytes, decode them to an image within the lambda
test's IMAGE_TOL of the JAX decode, match ``decompress_z_only`` within the
limits that ``tests/test_torch_models.py`` sets for the lambda model's
``decompress_finish`` (rtol = atol = 1e-4 per element: the semantic
adaptor alone, fed the same input in both frameworks, differs by ~5e-5
relative L2 on random weights), and the z-only rate-distortion forward
(eval mode) within the relative L2 of 1e-4 that
``tests/test_torch_train_modules.py`` sets for the lambda model's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from onedc_tpu_torch.models.onedc import OneDCRuntime
from torch_golden import runtime_reference
from torch_port_common import (  # noqa: F401  (a fixture)
    IMAGE_TOL,
    nchw,
    nhwc,
    one_torch_thread,
    port_model,
    seeded_images,
    to_np,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FWD_REL_L2 = 1e-4
TOL = dict(rtol=1e-4, atol=1e-4)


def assert_rel_l2(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= FWD_REL_L2, f"{what}: relative L2 {err:.2e}"


@pytest.fixture(scope="module")
def jax_z():
    """The JAX z-only runtime's outputs, stored by
    ``torch_golden/runtime_reference.py``."""
    return runtime_reference.load("z_only")


def codec_program_inputs():
    """(x, cond, z) of ``test_z_only_codec_programs_match_jax``: a 128x128
    image, its 16x16 latent and a 2x2 z."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    cond = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    z = rng.integers(0, 4 ** 7, (1, 2, 2)).astype(np.int32)
    return x, cond, z


@pytest.fixture(scope="module")
def port_z():
    return OneDCRuntime(port_model(z_only=True), device="cpu")


@pytest.mark.parametrize("which", [0, 1], ids=["64x64", "50x39"])
def test_z_only_container_and_image_match_jax(jax_z, port_z, which):
    image = seeded_images()[which]
    # JAX ``encode`` and ``decode`` of the image, stored
    want = runtime_reference.stream(jax_z, f"stream{which}")
    want_bpp = runtime_reference.bpp(jax_z, f"stream{which}")
    stream, bpp = port_z.encode(image)
    assert stream == want
    assert bpp == want_bpp and bpp["bits_y"] == 0
    img = port_z.decode(stream)
    ref = jax_z[f"decoded{which}"]
    assert img.shape == ref.shape == (1, *image.shape[1:])
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=IMAGE_TOL)
    # the codec-only decode reads the same z and runs the z-only programs
    x_hat, y_sem, hw, _, _ = port_z._codec_rt.decode(stream=stream)
    z = port_z.z_indices(port_z.parse(stream))
    with torch.no_grad():
        want = port_z.model.codec.decompress_z_only(torch.from_numpy(z))
    assert hw == image.shape[1:3]
    assert torch.equal(x_hat, want[0]) and torch.equal(y_sem, want[1])


def test_z_only_decode_batch_keeps_input_order(port_z, monkeypatch):
    """Chunks of ONEDC_PIPELINE_CHUNK rows (here 1, so two chunks of the
    one 64x64 bucket); each image equals its single decode."""
    monkeypatch.setenv("ONEDC_PIPELINE_CHUNK", "1")
    streams = [port_z.encode(im)[0] for im in seeded_images()]
    for got, s in zip(port_z.decode_batch(streams), streams):
        assert torch.equal(got, port_z.decode(s))


def test_z_only_codec_programs_match_jax(jax_z, port_z):
    """``decompress_z_only`` and the z-only rate-distortion forward in eval
    mode, on seeded inputs with a 2x2 latent z, as the lambda model's
    decode programs are held in ``tests/test_torch_models.py``: at 1x1 the
    tiny model's GroupNorms normalise 2 channels of one pixel per group,
    and their f32 rounding is amplified (2.4e-4 per element measured)."""
    # JAX's codec forward and ``decompress_z_only`` on these inputs, stored
    x, cond, z = codec_program_inputs()
    fwd = {k[len("fwd/"):]: v for k, v in jax_z.items()
           if k.startswith("fwd/")}
    x_hat, y_sem = jax_z["x_hat"], jax_z["y_sem"]
    pc = port_z.model.codec
    with torch.no_grad():
        got_x_hat, got_y_sem = pc.decompress_z_only(torch.from_numpy(z))
        got = pc(nchw(x), nchw(cond), training=False)
    np.testing.assert_allclose(nhwc(got_x_hat), np.asarray(x_hat), **TOL)
    np.testing.assert_allclose(nhwc(got_y_sem), np.asarray(y_sem), **TOL)
    for key in ("x_hat", "y_hat", "y_semantic", "z_semantic"):
        assert_rel_l2(nhwc(got[key]), fwd[key], key)
    np.testing.assert_array_equal(to_np(got["z_indices"]),
                                  np.asarray(fwd["z_indices"]))
    for key in ("bpp", "bpp_y", "bpp_hard_y", "bit"):
        assert_rel_l2(to_np(got[key]), fwd[key], key)


def test_exlow_config_builds_the_z_only_model():
    """``configs/inference_exlow.yaml``'s model keys build the port's
    z-only OneDC at full width (on the meta device: no weights)."""
    from onedc_tpu_torch.config import load_yaml
    from onedc_tpu_torch.models.onedc import OneDC

    cfg = load_yaml(Path(__file__).resolve().parents[1] / "configs"
                    / "inference_exlow.yaml")
    with torch.device("meta"):
        model = OneDC(**cfg["model"])
    assert model.codec.z_only and model.codec.force_zero_thres is None
