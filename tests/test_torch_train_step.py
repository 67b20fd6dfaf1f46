"""The port's stage-I training step against the JAX package's, on the CPU.

Three steps of the JAX ``make_train_step`` (``grad_accum=1``; its body,
``onedc_tpu/train/step.py:184-199``, written out with one jitted
``value_and_grad`` reused across the steps and the optax update run op
by op, so that the first step's prediction and gradients can be read
too) against three steps of the port's ``make_train_step`` on the same
tiny weights, the same 128x128 images and the same noise: JAX draws it
(``jax.random.uniform(key, y_res.shape, f32, -0.5, 0.5)``, the call at
``models/codec.py:291``) and the port is handed it. Warmup 2, so the first
update has lr 0. Also the optimizer against optax on a small tree, the
schedules, and the trainer's crops against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onedc_tpu.data import datasets as jdata
from onedc_tpu.train import losses as jlosses
from onedc_tpu.train import step as jstep
from onedc_tpu_torch.data import crops as pcrops
from onedc_tpu_torch.train import losses as plosses
from onedc_tpu_torch.train import step as pstep
from onedc_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_common import TINY, port_model, tiny_jax_model, to_np

# metrics (total_loss, bpp, bpp_hard_y, grad_norm, pix): relative error
METRIC_REL = 1e-4
# the trainable parameters' change since the start, relative L2 over all
# of them together
DELTA_REL_L2 = 1e-2
# forward outputs and first-step gradients, per tensor as in
# test_torch_train_modules.py: ||port - jax|| <= GRAD_REL_L2 * ||jax|| +
# GRAD_FLOOR * (global norm of all the gradients). Through the whole model
# the floor is 1e-5, not 1e-6: a gradient that is a sum over positions
# which nearly cancels (a bias ahead of a GroupNorm or a softmax; measured
# at the codec's output block, norms ~1e-3 of the global norm) keeps an
# absolute error of a few 1e-6 of the global norm
FWD_REL_L2 = 1e-4
GRAD_REL_L2 = 1e-3
GRAD_FLOOR = 1e-5

LR = 1e-4
WARMUP = 2
# MSE, not the configured L1: the L1 gradient sign(x - pred) flips wherever
# the two frameworks' predictions straddle the image (|x - pred| below
# their ~1e-4 difference), and those flips move the small gradients by a
# few percent; the L1 term itself is held in test_rd_loss_matches_jax
PIX_LOSS = "mse"
CLIP = 5.0
LMBDA_SCHEDULE = dict(start_step=0, end_step=4, start_value=0.5,
                      end_value=2.0)
N_STEPS = 3
# 128x128 images, not 64x64: at 64 the /64 level is one pixel, where the
# GroupNorms normalise 2-4 values per group at the tiny widths, so their
# gradients are large and ill-conditioned in either framework
IMAGE = 128
Y_SHAPE = (2, IMAGE // 16, IMAGE // 16, TINY["bottleneck_ch"])  # NHWC
METRICS = ("total_loss", "pix", "bpp", "bpp_hard_y", "grad_norm", "lmbda")


def _images(i):
    return np.random.default_rng(100 + i).uniform(
        -1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)


def _trainable(name: str) -> bool:
    return not name.startswith("vae.")


@pytest.fixture(scope="module")
def runs():
    jm, params = tiny_jax_model()
    params = jax.tree.map(jnp.asarray, params)
    loss = jlosses.RDLoss(lmbda=2.0, lmbda_schedule=LMBDA_SCHEDULE,
                          pix_loss_type=PIX_LOSS)

    def loss_fn(p, opt_step, image, rng):  # _make_stage1_loss_fn + pred
        enc, pred = jm.apply(p, image, training=True, noise_rng=rng)
        total, ld = loss(image, pred, enc["bpp"], step=opt_step,
                         training=True)
        ld["bpp_hard_y"] = enc["bpp_hard_y"]
        return total, (ld, pred)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    # the optax update runs op by op: jitting it took ~70 s of XLA compile
    # on a CPU, against ~45 s of op-by-op compiles and runs for three steps
    def apply(st, g):
        return st.apply_gradients(grads=g)

    state = jstep.create_train_state(jm, params, lr=LR, warmup_steps=WARMUP,
                                     grad_clip=CLIP, frozen=("vae",))
    jax_run = dict(metrics=[], params=[state_dict_from_jax(params)])
    noises = []
    for i in range(N_STEPS):
        key = jax.random.PRNGKey(i)
        (_, (ld, pred)), grads = grad_fn(state.params, state.step,
                                         _images(i), key)
        ld = dict(ld, grad_norm=optax.global_norm(grads))
        state = apply(state, grads)
        jax_run["metrics"].append({k: float(v) for k, v in ld.items()})
        jax_run["params"].append(state_dict_from_jax(state.params))
        noises.append(np.array(jax.random.uniform(
            key, Y_SHAPE, jnp.float32, -0.5, 0.5)))
        if i == 0:
            jax_run["pred"] = np.asarray(pred)
            jax_run["grads"] = state_dict_from_jax(grads)

    model = port_model().train().requires_grad_(True)
    pstate = pstep.create_train_state(model, lr=LR, warmup_steps=WARMUP,
                                      grad_clip=CLIP, frozen=("vae",))
    step_fn = pstep.make_train_step(plosses.RDLoss(
        lmbda=2.0, lmbda_schedule=LMBDA_SCHEDULE, pix_loss_type=PIX_LOSS))
    with torch.no_grad():
        _, pred = model(torch.from_numpy(_images(0)), training=True,
                        noise=torch.from_numpy(noises[0]))
    port_run = dict(metrics=[], pred=to_np(pred), params=[
        {k: v.clone() for k, v in model.state_dict().items()}])
    for i in range(N_STEPS):
        port_run["metrics"].append(step_fn(
            pstate, {"image": torch.from_numpy(_images(i))},
            noise=torch.from_numpy(noises[i])))
        port_run["params"].append({k: v.clone()
                                   for k, v in model.state_dict().items()})
        if i == 0:
            port_run["grads"] = {n: p.grad.clone()
                                 for n, p in model.named_parameters()
                                 if p.grad is not None}
    return jax_run, port_run


@pytest.mark.parametrize("step", range(N_STEPS))
def test_step_metrics_match_jax(runs, step):
    jax_run, port_run = runs
    want, got = jax_run["metrics"][step], port_run["metrics"][step]
    for key in METRICS:
        assert abs(got[key] - want[key]) <= METRIC_REL * abs(want[key]), (
            f"step {step} {key}: port {got[key]!r}, jax {want[key]!r}")


@pytest.mark.parametrize("step", range(1, N_STEPS))
def test_parameter_deltas_match_jax(runs, step):
    """The trainable parameters' change since the start; the first update
    (lr 0) changes nothing, bit for bit, in both."""
    jax_run, port_run = runs
    p0, j0 = port_run["params"][0], jax_run["params"][0]
    pk, jk = port_run["params"][step], jax_run["params"][step]
    names = [n for n in p0 if _trainable(n)]
    d_port = np.concatenate([(pk[n] - p0[n]).numpy().ravel() for n in names])
    d_jax = np.concatenate([(jk[n] - j0[n]).numpy().ravel() for n in names])
    if step == 1:
        assert not d_port.any() and not d_jax.any()
        return
    assert np.abs(d_jax).max() > 0
    err = np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax)
    assert err <= DELTA_REL_L2, f"step {step}: relative L2 {err:.3e}"


def test_frozen_vae_untouched(runs):
    _, port_run = runs
    first, last = port_run["params"][0], port_run["params"][-1]
    vae = [n for n in first if not _trainable(n)]
    assert vae and all(torch.equal(first[n], last[n]) for n in vae)


def test_onedc_forward_and_first_gradients_match_jax(runs):
    """``OneDC.forward`` in training: the predicted image, and the gradient
    of the first step's loss for every parameter (the frozen VAE decoder's
    included: it counts in ``grad_norm``; the VAE encoder's is zero in JAX
    and absent in the port, whose encoder runs without autograd)."""
    jax_run, port_run = runs
    pred_j, pred_p = jax_run["pred"], port_run["pred"]
    err = np.linalg.norm(pred_p - pred_j) / np.linalg.norm(pred_j)
    assert err <= FWD_REL_L2, f"pred_image: relative L2 {err:.2e}"
    want = {k: v.numpy() for k, v in jax_run["grads"].items()}
    got = {k: v.numpy() for k, v in port_run["grads"].items()}
    encoder = {k for k in want if k.startswith("vae.encoder.")}
    assert not encoder & set(got)
    assert all(not want[k].any() for k in encoder)
    assert set(got) == set(want) - encoder
    total = np.sqrt(sum(np.sum(w.astype(np.float64) ** 2)
                        for w in want.values()))
    bad = []
    for name in sorted(got):
        diff = np.linalg.norm(got[name].astype(np.float64) - want[name])
        norm = np.linalg.norm(want[name])
        if diff > GRAD_REL_L2 * norm + GRAD_FLOOR * total:
            bad.append((diff / norm, diff, norm, name))
    assert not bad, f"total {total:.3e}; " + "; ".join(
        f"{n}: rel {r:.2e} |diff| {d:.2e} |jax| {m:.2e}"
        for r, d, m, n in sorted(bad, reverse=True)[:12])


def test_adamw_matches_optax_with_and_without_clipping():
    """``AdamW`` against ``optax.chain(clip_by_global_norm, adamw)`` with the
    warmup-to-constant schedule (``jstep.make_optimizer``) on a small tree:
    5 updates whose gradients alternate below and above the clip norm."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jstep.make_optimizer(lr=1e-2, warmup_steps=3, grad_clip=1.0)
    jp = [jnp.asarray(a) for a in p0]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = pstep.AdamW(tp, lr=1e-2, warmup_steps=3, grad_clip=1.0)
    for i in range(5):
        scale = 0.05 if i % 2 else 3.0  # norm below / above the clip
        grads = [(scale * rng.standard_normal(s)).astype(np.float32)
                 for s in shapes]
        upd, opt_state = tx.update([jnp.asarray(g) for g in grads],
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert opt.count == 5


@pytest.mark.parametrize("pix_loss_type", ["l1", "mse"])
def test_rd_loss_matches_jax(pix_loss_type):
    """``RDLoss`` (no LPIPS) and its gradients against the JAX package's,
    with the lambda schedule read at a step."""
    rng = np.random.default_rng(4)
    x, x_hat = (rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
                for _ in range(2))
    bpp = np.float32(0.37)
    kw = dict(lmbda=2.0, lmbda_schedule=LMBDA_SCHEDULE,
              pix_loss_type=pix_loss_type)
    jl = jlosses.RDLoss(**kw)
    (total, ld), grads = jax.value_and_grad(
        lambda xh, b: jl(x, xh, b, step=jnp.int32(3)), argnums=(0, 1),
        has_aux=True)(x_hat, bpp)
    xh_t = torch.from_numpy(x_hat).requires_grad_()
    bpp_t = torch.tensor(bpp, requires_grad=True)
    ptotal, pld = plosses.RDLoss(**kw)(torch.from_numpy(x), xh_t, bpp_t,
                                       step=3)
    ptotal.backward()
    for key in ("pix", "lpips", "weighted_bpp", "distortion", "lmbda",
                "total_loss"):
        assert float(pld[key]) == pytest.approx(float(ld[key]), rel=1e-6,
                                                abs=1e-9), key
    np.testing.assert_allclose(to_np(xh_t.grad), np.asarray(grads[0]),
                               rtol=1e-6, atol=1e-9)
    assert float(bpp_t.grad) == pytest.approx(float(grads[1]), rel=1e-6)


def test_schedules_match_jax():
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, 3e-4, 4), optax.constant_schedule(3e-4)],
        boundaries=[4])
    for count in range(8):
        assert pstep.warmup_constant_lr(count, 3e-4, 4) == pytest.approx(
            float(sched(count)), rel=1e-7, abs=0)
    assert pstep.warmup_constant_lr(0, 3e-4, 4) == 0.0
    for step in (0, 1, 7, 2000, 4000, 9000):
        want = float(jlosses.lambda_schedule(jnp.int32(step), 0, 4000, 1e-4,
                                             4.6))
        assert plosses.lambda_schedule(step, 0, 4000, 1e-4, 4.6) == \
            pytest.approx(want, rel=1e-6)


def test_crops_match_jax():
    """The trainer's per-step choice and crop, copied from the JAX
    package: the same resolution, batch scale and pixels."""
    res, scales = [256, 384, 512], [1.0, 0.5, 0.25]
    jcrop = jdata.MultiResolutionCrop(res, scales, seed=0)
    pcrop = pcrops.MultiResolutionCrop(res, scales)
    img = np.random.default_rng(1).uniform(-1, 1, (600, 520, 3)).astype(
        np.float32)
    for step in range(20):
        assert pcrop.pick(step) == jcrop.pick(step)
        size = pcrop.pick(step)[0]
        np.testing.assert_array_equal(
            pcrops.random_crop(img, size, np.random.default_rng(step)),
            jdata.random_crop(img, size, np.random.default_rng(step)))
    small = img[:200, :300]  # upscaled by PIL before the crop
    np.testing.assert_array_equal(
        pcrops.random_crop(small, 256, np.random.default_rng(3)),
        jdata.random_crop(small, 256, np.random.default_rng(3)))
