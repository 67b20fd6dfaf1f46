"""The port's networks against the JAX package on the same weights, at the
tiny geometry (``__graft_entry__._tiny_cfg``), f32 on the CPU: the SD
UNet (eps and the reduced latent), the VAE decoder, and the codec's
decompress_begin / update x4 / finish fed identical symbols.

The codec's CDF indexes must be EXACTLY equal at every step: an index
that flips between the frameworks desyncs rANS, and this test names it
(ROADMAP Queue 3) instead of leaving it to show up as garbage symbols.
"""

import jax
import numpy as np
import pytest
import torch

from onedc_tpu_torch.entropy.gaussian import scale_table
from torch_port_common import (  # noqa: F401  (a fixture)
    TINY,
    nchw,
    nhwc,
    one_torch_thread,
    port_model,
    tiny_jax_model,
    to_np,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jm, params = tiny_jax_model()
    return jm, params, port_model()


def test_sd_unet_matches_jax(models):
    jm, params, pm = models
    rng = np.random.default_rng(1)
    b, ctx_tokens = 2, 4
    x = rng.standard_normal((b, 16, 16, TINY["ctrl_ch"])).astype(np.float32)
    ctx = rng.standard_normal(
        (b, ctx_tokens, TINY["context_dim"])).astype(np.float32)
    t = np.full((b,), 999, np.int32)

    def unet(m, x, t, c):
        return m.unet(x, t, c)

    eps_j, red_j = jax.jit(lambda p, x, t, c: jm.apply(
        p, x, t, c, method=unet))(params, x, t, ctx)
    with torch.no_grad():
        eps_p, red_p = pm.unet(nchw(x), torch.from_numpy(t),
                               torch.from_numpy(ctx))
    np.testing.assert_allclose(nhwc(eps_p), np.asarray(eps_j), **TOL)
    np.testing.assert_allclose(nhwc(red_p), np.asarray(red_j), **TOL)


def test_vae_decoder_matches_jax(models):
    jm, params, pm = models
    z = np.random.default_rng(2).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    ref = jax.jit(lambda p, z: jm.apply(
        p, z, method=lambda m, z: m.vae.decode(z)))(params, z)
    with torch.no_grad():
        out = nhwc(pm.vae.decode(nchw(z)))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_codec_decompress_programs_match_jax(models):
    """begin -> update x4 -> finish, symbols drawn once and fed to both."""
    jm, params, pm = models
    rng = np.random.default_rng(3)
    z = rng.integers(0, 4 ** 7, (2, 2, 2)).astype(np.int32)

    def run(method, *args):
        return jax.jit(lambda p, *a: jm.apply(p, *a, method=method))(
            params, *args)

    st_j = run(lambda m, z: m.codec.decompress_begin(z), z)
    with torch.no_grad():
        st_p = pm.codec.decompress_begin(torch.from_numpy(z))
    for key in ("common", "means", "z_semantic"):
        np.testing.assert_allclose(to_np(st_p[key]), np.asarray(st_j[key]),
                                   rtol=1e-5, atol=1e-5)
    table = scale_table()
    common_j, common_p = st_j["common"], st_p["common"]
    z_sem = np.array(st_j["z_semantic"])
    for step in range(4):
        idx_j = np.asarray(st_j["indexes_r"])
        idx_p = to_np(st_p["indexes_r"])
        assert idx_p.dtype == idx_j.dtype == np.uint8
        flips = int((idx_p != idx_j).sum())
        assert flips == 0, (f"cross-framework CDF-index flip: {flips} of "
                            f"{idx_j.size} indexes differ at step {step}")
        sym = np.round(rng.standard_normal(idx_j.shape)
                       * table[idx_j.astype(np.int64)]).astype(np.int16)
        st_j = run(lambda m, *a, s=step: m.codec.decompress_update(s, *a),
                   sym, st_j["means"], st_j["y_hat"], common_j)
        with torch.no_grad():
            st_p = pm.codec.decompress_update(
                step, torch.from_numpy(sym), st_p["means"], st_p["y_hat"],
                common_p)
        np.testing.assert_allclose(to_np(st_p["y_hat"]),
                                   np.asarray(st_j["y_hat"]),
                                   rtol=1e-5, atol=1e-5)
    assert st_p["indexes_r"] is None and st_j["indexes_r"] is None

    y_hat = np.array(st_j["y_hat"])
    x_j, sem_j = run(lambda m, y, s: m.codec.decompress_finish(y, s),
                     y_hat, z_sem)
    with torch.no_grad():
        x_p, sem_p = pm.codec.decompress_finish(torch.from_numpy(y_hat),
                                                torch.from_numpy(z_sem))
    np.testing.assert_allclose(nhwc(x_p), np.asarray(x_j), **TOL)
    np.testing.assert_allclose(nhwc(sem_p), np.asarray(sem_j), **TOL)
