"""The slice as a whole: streams written by the JAX package's
``OneDCRuntime.encode`` decode in the port (tiny geometry, f32, CPU).

The port must read the same CDF indexes and the same rANS symbols at all
4 steps, give a y_hat within 1e-5 of the JAX loop's (each framework
computes the means with its own float math, so bit equality is not
expected), and an image within 2e-3 of the JAX decode (the UNet's x0
recovery divides by sqrt(alpha_bar(999)) ~ 0.069, which amplifies the
frameworks' f32 differences before the VAE).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_synthetic_stream
from onedc_tpu.models.onedc import OneDCRuntime as JaxOneDCRuntime
from onedc_tpu_torch.models.onedc import OneDCRuntime
from torch_port_common import port_model, tiny_jax_model, to_np

Y_HAT_TOL = 1e-5
IMAGE_TOL = 2e-3


@pytest.fixture(scope="module")
def jax_side():
    jm, params = tiny_jax_model()
    rt = JaxOneDCRuntime(jm, params)
    rt.update(force=True)
    rng = np.random.default_rng(7)
    images = [rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32),
              rng.uniform(-1, 1, (1, 50, 39, 3)).astype(np.float32)]
    streams = [bytes(rt.encode(jnp.asarray(im))[0]) for im in images]
    return rt, streams


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


def _jax_loop(jrt, stream):
    """The JAX four-part loop, step by step: [(indexes, symbols)], y_hat."""
    crt = jrt._codec_rt
    from onedc_tpu.entropy.framing import decode_i
    dec = decode_i(stream, crt.fsq.index_bits, jrt.ds)
    zh, zw = dec["pad_height"] // jrt.ds, dec["pad_width"] // jrt.ds
    z = crt.fsq.unpack_indices(dec["bit_stream_z"], zh * zw).reshape(
        1, zh, zw)
    crt.entropy_coder.set_stream(dec["bit_stream_y"])
    st = crt._begin(crt.params, jnp.asarray(z))
    common, steps = st["common"], []
    for step in range(4):
        idx = np.asarray(st["indexes_r"])
        sym = crt.gaussian_coder.decode_stream_with_indexes(idx)
        steps.append((idx, sym))
        st = crt._update[step](crt.params, jnp.asarray(sym), st["means"],
                               st["y_hat"], common)
    return steps, np.asarray(st["y_hat"])


@pytest.mark.parametrize("which", [0, 1], ids=["64x64", "50x39"])
def test_port_decodes_jax_stream(jax_side, port_decodes, which):
    jrt, streams = jax_side
    stream = streams[which]
    jax_steps, jax_y_hat = _jax_loop(jrt, stream)
    img, trace = port_decodes[which]
    for step, ((ij, sj), (ip, sp)) in enumerate(zip(jax_steps,
                                                    trace["steps"])):
        flips = int((ij != ip).sum())
        assert flips == 0, (f"cross-framework CDF-index flip: {flips} of "
                            f"{ij.size} indexes differ at step {step}")
        np.testing.assert_array_equal(sp, sj, err_msg=f"symbols, step {step}")
    np.testing.assert_allclose(to_np(trace["y_hat"]), jax_y_hat,
                               rtol=0, atol=Y_HAT_TOL)
    ref = np.asarray(jrt.decode(stream=stream))
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
