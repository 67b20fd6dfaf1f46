"""The JAX package's stage-II outputs on the port tests' seeded inputs.

``tests/test_torch_stage2.py`` holds the port against these arrays, so the
suite pays no JAX compile for them; ``tests/test_torch_stage2_golden.py``
(marked slow) computes them again and asserts they equal the stored file.
The JAX package is frozen, so the file changes only with the inputs.

Inputs, all made here from numpy seeds and rebuilt by the tests without
JAX: the tiny ``SDGuidance`` (``GUIDANCE``) and the tiny OneDC
(``torch_port_common.TINY``) with ``torch_port_common.seeded_state``
weights, carried to the JAX trees by ``utils/convert.py:
flat_jax_from_state_dict``; latents, text embeddings and images from
``inputs()``. The JAX random draws (timesteps, Gaussian and codec noise)
are stored with the outputs and handed to the port.

Gradients are stored whole for the GAN head and as digests for the UNets
(per tensor: the L2 norm and the first 16 values in the torch layout), to
keep the file small. The steps' gradients come out of the real
``make_generator_step`` / ``make_guidance_step`` through an optimizer that
keeps the gradients as its state and changes no parameter.

Write the file (about ten minutes of JAX compiles on a CPU):
  JAX_PLATFORMS=cpu python tests/torch_golden/stage2_reference.py
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE.parent.parent))

from torch_port_common import TINY, load_seeded  # noqa: E402

GOLDEN = HERE / "stage2.npz"
GUIDANCE = dict(block_channels=(32, 32, 64, 64), context_dim=32)
GUIDANCE_SEED = 11
ONEDC_SEED = 12
B = 2
LATENT = 16      # the guidance tests' latents: a 2x2 mid grid, padded
# the steps' images: 16x16 latents. Not 64x64: there the UNets' /64 level
# is one pixel, where each GroupNorm group holds two values at the tiny
# widths and the gradients are ill-conditioned in either framework
# (tests/test_torch_train_step.py chose 128 for the same reason)
IMAGE = 128
TOKENS = 7
DIGEST = 16


def inputs():
    """The tests' seeded arrays, NCHW latents."""
    rng = np.random.default_rng(5)
    f = np.float32
    return {
        "lat": (0.5 * rng.standard_normal((B, 4, LATENT, LATENT))).astype(f),
        "real": (0.5 * rng.standard_normal((B, 4, LATENT, LATENT))).astype(f),
        "text": rng.standard_normal((B, TOKENS, 32)).astype(f),
        "uncond": rng.standard_normal((B, TOKENS, 32)).astype(f),
        "t": np.array([17, 503], np.int64),
        "feat8": rng.standard_normal((B, 64, 8, 8)).astype(f),
        "feat35": rng.standard_normal((B, 64, 3, 5)).astype(f),
        "image": rng.uniform(-1, 1, (B, IMAGE, IMAGE, 3)).astype(f),
        "eval0": rng.uniform(-1, 1, (1, 64, 64, 3)).astype(f),
        "eval1": rng.uniform(-1, 1, (1, 70, 130, 3)).astype(f),
    }


def port_guidance():
    from onedc_tpu_torch.models.dmd import SDGuidance
    with torch.device("meta"):
        g = SDGuidance(**GUIDANCE)
    return load_seeded(g, GUIDANCE_SEED)


def port_onedc():
    from onedc_tpu_torch.models.onedc import OneDC
    with torch.device("meta"):
        m = OneDC(**TINY)
    return load_seeded(m, ONEDC_SEED)


def digest(prefix: str, named, out: dict) -> None:
    """Per tensor of ``named`` ((name, torch-layout array)): its L2 norm
    and its first ``DIGEST`` values."""
    for name, arr in named:
        arr = np.asarray(arr, np.float32)
        out[f"{prefix}norm/{name}"] = np.float32(np.linalg.norm(arr))
        out[f"{prefix}head/{name}"] = arr.reshape(-1)[:DIGEST].copy()


def _nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def compute() -> dict:
    """Every stored array, from the JAX package."""
    import jax
    import jax.numpy as jnp
    import optax

    from onedc_tpu.models.dmd import SDGuidance
    from onedc_tpu.models.onedc import OneDC
    from onedc_tpu.train import trainer_stage2 as jt2
    from onedc_tpu.train.losses import RDLoss
    from onedc_tpu.train.step import TrainState
    from onedc_tpu_torch.utils.convert import (flat_jax_from_state_dict,
                                               state_dict_from_jax)
    from onedc_tpu_torch.utils.safetensors import unflatten_params

    jax.config.update("jax_default_matmul_precision", "highest")
    x = inputs()
    out = {}

    def tree(module):
        return jax.tree.map(jnp.asarray, unflatten_params(
            flat_jax_from_state_dict(module.state_dict())))

    g = SDGuidance(**GUIDANCE)
    gp = tree(port_guidance())
    lat, real = jnp.asarray(_nhwc(x["lat"])), jnp.asarray(_nhwc(x["real"]))
    text, uncond = jnp.asarray(x["text"]), jnp.asarray(x["uncond"])

    # the UNet, both ways, and the head with and without the pad
    def unet(p, s, t, c, classify):
        return g.apply(p, s, t, c, classify,
                       method=lambda m, *a: m.fake_unet(*a))
    for classify in (False, True):
        out[f"unet_classify{int(classify)}"] = _nchw(jax.jit(
            unet, static_argnums=4)(gp, lat, jnp.asarray(x["t"]), text,
                                    classify))
    for key in ("feat8", "feat35"):
        out[f"cls_{key}"] = np.asarray(jax.jit(lambda p, f: g.apply(
            p, f, method=lambda m, f: m.cls_pred_branch(f)))(
            gp, jnp.asarray(_nhwc(x[key]))))

    # the two forwards, their draws, and their gradients
    gkey, qkey = jax.random.PRNGKey(2), jax.random.PRNGKey(3)
    out.update(generator_draws(gkey, B, LATENT, LATENT, "gen/"))
    out.update(guidance_draws(qkey, B, LATENT, LATENT, "guid/"))

    def gen_fwd(p, latents):
        return g.apply(p, latents, text, uncond, gkey,
                       method=g.generator_forward)

    def guid_fwd(p, fl, rl):
        return g.apply(p, fl, rl, text, uncond, text, qkey,
                       method=g.guidance_forward)

    for k, v in jax.jit(gen_fwd)(gp, lat).items():
        out[f"gen_out/{k}"] = np.asarray(v)
    for k, v in jax.jit(guid_fwd)(gp, lat, real).items():
        out[f"guid_out/{k}"] = np.asarray(v)
    for term in ("loss_dm", "gen_cls_loss"):
        out[f"gen_grad/{term}"] = _nchw(jax.jit(jax.grad(
            lambda l, term=term: gen_fwd(gp, l)[term]))(lat))

    def guid_loss(p):
        o = guid_fwd(p, lat, real)
        return o["loss_fake_mean"] + 1e-2 * o["guidance_cls_loss"]
    grads = state_dict_from_jax(jax.jit(jax.grad(guid_loss))(gp))
    digest("guid_grad/", [(k, v.numpy()) for k, v in sorted(grads.items())
                          if k.startswith("fake_unet.")], out)
    for k, v in grads.items():
        if k.startswith("cls_pred_branch."):
            out[f"guid_grad/{k}"] = v.numpy()
        if k.startswith("real_unet."):
            assert not v.any(), k  # no gradient reaches the real UNet

    # one generator turn and one guidance turn of the JAX steps
    onedc = OneDC(**TINY)
    op = tree(port_onedc())
    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))
    gen_state = TrainState.create(apply_fn=onedc.apply, params=op,
                                  tx=keep_grads)
    guid_state = TrainState.create(apply_fn=g.apply, params=gp,
                                   tx=keep_grads)
    image = jnp.asarray(x["image"])
    skey, rkey = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    gen_step = jax.jit(jt2.make_generator_step(onedc, g))
    gen_state, gmet, aux = gen_step(gen_state, gp, {"image": image}, text,
                                    uncond, skey)
    noise_key, guid_key = jax.random.split(skey)
    h = IMAGE // 8
    out["step/bit_noise"] = np.asarray(jax.random.uniform(
        noise_key, (B, IMAGE // 16, IMAGE // 16, TINY["bottleneck_ch"]),
        jnp.float32, -0.5, 0.5))
    out.update(generator_draws(guid_key, B, h, h, "step/gen/"))
    for k, v in gmet.items():
        out[f"step/gen_metrics/{k}"] = np.asarray(v)
    for k, v in aux.items():
        out[f"step/{k}"] = _nchw(v)
    ggrads = state_dict_from_jax(gen_state.opt_state)
    digest("step/gen_grad/", [(k, v.numpy()) for k, v in
                              sorted(ggrads.items())
                              if k.startswith("unet.")], out)

    guid_step = jax.jit(jt2.make_guidance_step(g))
    guid_state, qmet = guid_step(guid_state, aux["fake_latents"],
                                 aux["real_latents"], text, uncond, rkey)
    out.update(guidance_draws(rkey, B, h, h, "step/guid/"))
    for k, v in qmet.items():
        out[f"step/guid_metrics/{k}"] = np.asarray(v)
    qgrads = state_dict_from_jax(guid_state.opt_state)
    digest("step/guid_grad/", [(k, v.numpy()) for k, v in
                               sorted(qgrads.items())
                               if not k.startswith("real_unet.")], out)

    # the eval epoch, as tests/test_dmd.py:test_stage2_eval_one_epoch runs
    # it, on two images given as the loader
    from types import SimpleNamespace

    from onedc_tpu.config import Config
    from onedc_tpu.utils.logging import get_logger, make_writer
    import tempfile
    tr = jt2.Stage2Trainer.__new__(jt2.Stage2Trainer)
    tr.onedc = onedc
    tr.gen_state = SimpleNamespace(params=op)
    tr.rd_loss = RDLoss(lmbda=0.0)
    tr.eval_loader = [{"image": x["eval0"]}, {"image": x["eval1"]}]
    tr.log = get_logger("stage2_reference")
    tr.cfg = Config.wrap({})
    with tempfile.TemporaryDirectory() as tmp:
        tr.writer = make_writer(os.path.join(tmp, "tb"))
        for k, v in tr.eval_one_epoch(step=1).items():
            out[f"eval/{k}"] = np.float64(v)
    return out


def generator_draws(key, b, h, w, prefix: str) -> dict:
    """``SDGuidance.generator_forward``'s draws from ``key`` (JAX
    ``dmd.py:168-180``, ``:121-130``, ``:107-112``), NCHW noise."""
    import jax
    import jax.numpy as jnp
    rng_dm, rng_cls = jax.random.split(key)
    t_rng, n_rng = jax.random.split(rng_dm)
    out = {f"{prefix}dm_t": jax.random.randint(t_rng, (b,), 20, 641),
           f"{prefix}dm_noise": jax.random.normal(n_rng, (b, h, w, 4),
                                                  jnp.float32)}
    t_rng, n_rng = jax.random.split(rng_cls)
    out[f"{prefix}cls_t"] = jax.random.randint(t_rng, (b,), 0, 1000)
    out[f"{prefix}cls_noise"] = jax.random.normal(n_rng, (b, h, w, 4),
                                                  jnp.float32)
    return _draws(out)


def guidance_draws(key, b, h, w, prefix: str) -> dict:
    """``SDGuidance.guidance_forward``'s draws from ``key`` (JAX
    ``dmd.py:184-201``, ``:153-160``, ``:107-112``), NCHW noise."""
    import jax
    import jax.numpy as jnp
    out = {}
    for name, sub, high in zip(("fake", "real_cls", "fake_cls"),
                               jax.random.split(key, 3), (1000, 1000, 1000)):
        t_rng, n_rng = jax.random.split(sub)
        out[f"{prefix}{name}_t"] = jax.random.randint(t_rng, (b,), 0, high)
        out[f"{prefix}{name}_noise"] = jax.random.normal(
            n_rng, (b, h, w, 4), jnp.float32)
    return _draws(out)


def _draws(d: dict) -> dict:
    return {k: (_nchw(v) if np.ndim(v) == 4 else
                np.asarray(v).astype(np.int64)) for k, v in d.items()}


def load() -> dict:
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":
    arrays = compute()
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: {len(arrays)} arrays, "
          f"{GOLDEN.stat().st_size} bytes")
