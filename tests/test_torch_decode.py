"""The lambda model as a whole (tiny geometry, f32, CPU): streams written
by the JAX package's ``OneDCRuntime.encode`` decode in the port, and the
port's own encode writes the same bytes.

The port must read the same CDF indexes and the same rANS symbols at all
4 steps, give a y_hat within 1e-5 of the JAX loop's (each framework
computes the means with its own float math, so bit equality is not
expected), and an image within 2e-3 of the JAX decode (the UNet's x0
recovery divides by sqrt(alpha_bar(999)) ~ 0.069, which amplifies the
frameworks' f32 differences before the VAE). Its encode must write the
JAX package's containers byte for byte, from ``encode``, ``encode_batch``
and ``encode_many``, and each stream must decode in the port to its
writer's symbols and y_hat.
"""

import numpy as np
import pytest
import torch

from chip_smoke import write_synthetic_stream
from onedc_tpu_torch.models.onedc import OneDCRuntime
from torch_golden import runtime_reference
from torch_port_common import (
    IMAGE_TOL,
    port_model,
    seeded_images,
    to_np,
)

Y_HAT_TOL = 1e-5


@pytest.fixture
def one_thread():
    """torch on one thread for a test whose checks do not depend on the
    thread count (bytes, plans, JAX limits), as
    ``torch_port_common.one_torch_thread`` for a module: the suite's other
    workers starve a full thread pool. The single and batched decodes keep
    torch's default, under which their 1e-4 limit was set."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_encodes():
    """The JAX runtime's outputs on the test images (its containers and
    bpp, four-part loops, decodes, write plans, the ``force_zero_thres``
    plan and container, the codec-only decode), stored by
    ``torch_golden/runtime_reference.py``."""
    return runtime_reference.load("decode")


@pytest.fixture(scope="module")
def jax_side(jax_encodes):
    return jax_encodes, [runtime_reference.stream(jax_encodes, f"stream{i}")
                         for i in range(len(seeded_images()))]


@pytest.fixture(scope="module")
def port_rt():
    return OneDCRuntime(port_model(), device="cpu")


@pytest.fixture(scope="module")
def port_decodes(jax_side, port_rt):
    """The port's traced single decode of each stream: [(image, trace)],
    computed once for the tests that hold it against JAX and against the
    batched decode."""
    out = []
    for stream in jax_side[1]:
        trace = {}
        out.append((port_rt.decode(stream, trace), trace))
    return out


@pytest.mark.parametrize("which", [0, 1], ids=["64x64", "50x39"])
def test_port_decodes_jax_stream(jax_side, port_decodes, which):
    gold, streams = jax_side
    # JAX's four-part loop on the stream (indexes and symbols per step,
    # y_hat) and its decode, stored
    jax_steps = [(gold[f"loop{which}/indexes{st}"],
                  gold[f"loop{which}/symbols{st}"]) for st in range(4)]
    jax_y_hat = gold[f"loop{which}/y_hat"]
    img, trace = port_decodes[which]
    for step, ((ij, sj), (ip, sp)) in enumerate(zip(jax_steps,
                                                    trace["steps"])):
        flips = int((ij != ip).sum())
        assert flips == 0, (f"cross-framework CDF-index flip: {flips} of "
                            f"{ij.size} indexes differ at step {step}")
        np.testing.assert_array_equal(sp, sj, err_msg=f"symbols, step {step}")
    np.testing.assert_allclose(to_np(trace["y_hat"]), jax_y_hat,
                               rtol=0, atol=Y_HAT_TOL)
    ref = gold[f"decoded{which}"]
    assert img.shape == ref.shape and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=IMAGE_TOL)


def test_decode_batch_equals_single_decodes(jax_side, port_rt,
                                           port_decodes):
    """Both streams pad to 64x64: one bucket. Its four-part loop runs the
    prior nets one image at a time, so y_hat is bit-identical to the single
    decodes'; the batched UNet and VAE may round differently from batch 1
    (1e-4)."""
    _, streams = jax_side
    batch = port_rt.decode_batch(streams)
    bucket = {}
    port_rt.decode_padded([port_rt.parse(s) for s in streams], bucket)
    for row, (got, (want, single)) in enumerate(zip(batch, port_decodes)):
        assert torch.equal(bucket["y_hat"][row:row + 1], single["y_hat"])
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4)


@pytest.mark.usefixtures("one_thread")
def test_write_synthetic_stream_round_trips(port_rt):
    stream, y_hat, steps = write_synthetic_stream(port_rt, 64, 128, seed=1)
    trace = {}
    img = port_rt.decode(stream, trace)
    for (iw, sw), (ir, sr) in zip(steps, trace["steps"]):
        np.testing.assert_array_equal(ir, iw)
        np.testing.assert_array_equal(sr, sw)
    assert torch.equal(trace["y_hat"], y_hat)
    assert img.shape == (1, 64, 128, 3) and torch.isfinite(img).all()
    stage_ms = trace["stage_ms"]
    assert list(stage_ms) == ["begin", "updates_with_rans", "finish_unet_x0",
                              "vae"]
    assert all(ms > 0 for ms in stage_ms.values())


def _plan_diff(gold, which, port_rt, image) -> str:
    """Where the port's write plan of one image differs from JAX's (stored):
    the count of differing indexes and symbols at each step."""
    pout = port_rt.write_plan(image)
    return "; ".join(
        f"step {s}: {int((gold[f'plan{which}/indexes_w{s}'] != to_np(pout['indexes_w'][s])).sum())} "
        f"indexes, {int((gold[f'plan{which}/y_q_w{s}'] != to_np(pout['y_q_w'][s])).sum())} symbols"
        for s in range(4))


@pytest.mark.parametrize("which", [0, 1], ids=["64x64", "50x39"])
@pytest.mark.usefixtures("one_thread")
def test_port_encode_writes_jax_bytes(jax_encodes, port_rt, which):
    gold = jax_encodes
    image = seeded_images()[which]
    stream, bpp = port_rt.encode(image)
    assert stream == runtime_reference.stream(gold, f"stream{which}"), \
        _plan_diff(gold, which, port_rt, image)
    assert bpp == runtime_reference.bpp(gold, f"stream{which}")


def _assert_decodes_to_plan(rt, stream, plan, row):
    """The port decodes ``stream`` to row ``row`` of the device write plan
    ``plan``: the same indexes and symbols at each step, the same y_hat."""
    trace = {}
    rt.decode(stream, trace)
    for s, (idx, sym) in enumerate(trace["steps"]):
        np.testing.assert_array_equal(idx, to_np(plan["indexes_w"][s][row:row + 1]))
        np.testing.assert_array_equal(sym, to_np(plan["y_q_w"][s][row:row + 1]))
    assert torch.equal(trace["y_hat"], plan["y_hat"][row:row + 1])


@pytest.mark.usefixtures("one_thread")
def test_encode_many_and_batch_match_serial(jax_side, port_rt):
    """``encode_many`` over two sizes and ``encode_batch`` of a same-size
    pair write the serial encodes' bytes (the port's copy of
    tests/test_onedc.py::test_encode_many_matches_serial), and every
    stream decodes to its writer's plan."""
    images = seeded_images()
    _, streams = jax_side
    many = port_rt.encode_many(images, chunk=1)
    assert [s for s, _ in many] == streams
    pair = np.concatenate([images[0], images[0][:, ::-1]])
    serial = [port_rt.encode(pair[i:i + 1])[0] for i in range(2)]
    batch = port_rt.encode_batch(pair)
    assert [s for s, _ in batch] == serial
    plan = port_rt.write_plan(pair)
    for row, (stream, _) in enumerate(batch):
        _assert_decodes_to_plan(port_rt, stream, plan, row)
    for image, (stream, _) in zip(images, many):
        _assert_decodes_to_plan(port_rt, stream,
                                port_rt.write_plan(image), 0)


@pytest.mark.parametrize("thres", [None, 0.2], ids=["no-skip", "skip-0.2"])
@pytest.mark.usefixtures("one_thread")
def test_write_plan_matches_jax_compress(jax_encodes, port_rt, thres):
    """The port's device write plan (VAE + ``LatentCodec.compress``, the
    plan built through the decoder's programs) against the JAX package's
    (``forward_four_part_prior(..., write=True)``) on the same padded
    image: z indices, CDF indexes and symbols exactly, y_hat within
    Y_HAT_TOL; with ``force_zero_thres`` 0.2 about two thirds of the
    symbols are skipped (index -1), and the containers stay equal."""
    gold = jax_encodes
    # JAX's plan of the image (``_encode_dev`` of the padded image) and its
    # container, from a runtime with ``force_zero_thres`` where set; stored
    key = "plan1" if thres is None else "plan1_skip"
    want_stream = "stream1" if thres is None else "stream1_skip"
    if thres is not None:
        port_rt = OneDCRuntime(port_model(force_zero_thres=thres),
                               device="cpu")
    image = seeded_images()[1]
    got = port_rt.write_plan(image)
    np.testing.assert_array_equal(to_np(got["z_indices"]),
                                  gold[f"{key}/z_indices"])
    skipped = 0
    for s in range(4):
        idx = to_np(got["indexes_w"][s])
        assert idx.dtype == (np.uint8 if thres is None else np.int16)
        np.testing.assert_array_equal(idx, gold[f"{key}/indexes_w{s}"])
        np.testing.assert_array_equal(to_np(got["y_q_w"][s]),
                                      gold[f"{key}/y_q_w{s}"])
        skipped += int((idx < 0).sum())
    assert (skipped > 0) == (thres is not None)
    np.testing.assert_allclose(to_np(got["y_hat"]), gold[f"{key}/y_hat"],
                               rtol=0, atol=Y_HAT_TOL)
    assert port_rt.encode(image) == (
        runtime_reference.stream(gold, want_stream),
        runtime_reference.bpp(gold, want_stream))


@pytest.mark.usefixtures("one_thread")
def test_codec_runtime_decode_and_files_match_jax(jax_encodes, port_rt,
                                                  tmp_path):
    """``encode(..., fp=)`` writes the container to a file (``bpp_file``
    counts its bytes), ``CodecRuntime.encode`` of the padded image and its
    VAE latent writes the same bytes, and the codec-only
    ``CodecRuntime.decode(fp=)``
    reads it back to the control tensor and semantic tokens of the JAX
    package's ``CodecRuntime.decode``, within the limits of
    ``tests/test_torch_models.py``'s codec decode programs."""
    gold = jax_encodes
    image = seeded_images()[1]
    path = tmp_path / "image.bin"
    stream, bpp = port_rt.encode(image, fp=path)
    assert path.read_bytes() == stream
    assert bpp["bpp_file"] == bpp["bpp"] > 0
    # the codec-level encode of the padded image and its VAE latent
    padded = port_rt.pad(image)
    cond = port_rt.model.vae_encode_image(padded)
    assert port_rt._codec_rt.encode(padded, cond, 39, 50)[0] == stream
    x_hat, y_sem, hw, pad_hw, pad = port_rt._codec_rt.decode(fp=path)
    # JAX ``CodecRuntime.decode(stream=)`` of the container, stored
    assert stream == runtime_reference.stream(gold, "stream1")
    jx, jy = gold["codec1/x_hat"], gold["codec1/y_sem"]
    g = tuple(int(v) for v in gold["codec1/geometry"])
    assert (hw, pad_hw, pad) == (g[:2], g[2:4], g[4:]) == (
        (50, 39), (64, 64), (0, 25, 0, 14))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(x_hat.permute(0, 2, 3, 1)),
                               np.asarray(jx), **tol)
    np.testing.assert_allclose(to_np(y_sem.permute(0, 2, 3, 1)),
                               np.asarray(jy), **tol)
