"""One stage-I step as ``configs/train_stage1.yaml`` runs it, the port's
against the JAX package's, on the CPU at the tiny width: the Codeformer
distillation against the frozen VQGAN, Adafactor, ``grad_accum`` 2 and
remat, on the same weights, images and noise.

The JAX side is ``make_train_step(model, loss, remat=True, grad_accum=2)``'s
body (``onedc_tpu/train/step.py:184-199``) written out at count 0: one
``jax.jit`` of ``grad_accum_scan`` over ``value_and_grad`` of
``_make_stage1_loss_fn`` (remat on), whose gradients can be read (the
whole step under one ``jax.jit``, the optax update in it, took ~7 minutes
to compile on a CPU). Its micro-batch i draws the codec's noise from
``fold_in(rng, i)``; the port is handed those draws, micro-batch i on its
own rows, and runs through ``Trainer``'s step in both
``grad_accum_mode``s. Adafactor's update rule is held against optax in
``test_torch_train_levers.py``. Its own file: the compile takes most of
its time, and ``--dist loadfile`` runs it beside the other files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onedc_tpu.train import losses as jlosses
from onedc_tpu.train import step as jstep
from onedc_tpu_torch.train import step as pstep
from onedc_tpu_torch.train import trainer as ptrainer
from onedc_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_common import (  # noqa: F401  (a fixture)
    CODEFORMER,
    TINY,
    one_torch_thread,
    tiny_jax_model,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# metrics, relative (``tests/test_torch_train_step.py``'s METRIC_REL); the
# gradients per tensor as there: ||port - jax|| <= GRAD_REL_L2 * ||jax|| +
# GRAD_FLOOR * (global norm of all the gradients)
METRIC_REL = 1e-4
GRAD_REL_L2 = 1e-3
GRAD_FLOOR = 1e-5
LR, WARMUP, CLIP = 1e-3, 1, 5.0
# MSE, not L1: the L1 gradient's sign flips where the two frameworks'
# predictions straddle the image (``test_torch_train_step.py``)
PIX_LOSS = "mse"
LMBDA_SCHEDULE = dict(start_step=0, end_step=4, start_value=0.5,
                      end_value=2.0)
ACCUM = 2
IMAGE = 128
METRICS = ("total_loss", "pix", "bpp", "bpp_hard_y", "grad_norm", "lmbda",
           "codeformer_ce_loss", "codeformer_mse_loss", "codeformer_loss",
           "weighted_codeformer_loss")


def _images():
    return np.random.default_rng(200).uniform(
        -1, 1, (2, IMAGE, IMAGE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step at count 0: its metrics, its mean gradients, the
    parameters and the noise its micro-batches drew."""
    jm, params = tiny_jax_model(codeformer=True)
    params = jax.tree.map(jnp.asarray, params)
    loss = jlosses.RDLoss(lmbda=2.0, lmbda_schedule=LMBDA_SCHEDULE,
                          pix_loss_type=PIX_LOSS)
    loss_fn = jstep._make_stage1_loss_fn(jm, loss, True, 1e-3, 1e-2)

    def grads_and_metrics(p, opt_step, image, rng):
        grad_fn = jax.value_and_grad(
            lambda p, image, rng: loss_fn(p, opt_step, image, rng),
            has_aux=True)
        grads, metrics, _ = jstep.grad_accum_scan(grad_fn, p, (image,), rng,
                                                  ACCUM)
        return grads, metrics

    key = jax.random.PRNGKey(0)
    grads, metrics = jax.jit(grads_and_metrics)(
        params, 0, jnp.asarray(_images()), key)
    metrics["grad_norm"] = optax.global_norm(grads)
    micro = (2 // ACCUM, IMAGE // 16, IMAGE // 16, TINY["bottleneck_ch"])
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads=state_dict_from_jax(grads),
        params=state_dict_from_jax(params),
        noise=np.concatenate([np.asarray(jax.random.uniform(
            jax.random.fold_in(key, j), micro, jnp.float32, -0.5, 0.5))
            for j in range(ACCUM)]))


@pytest.fixture(scope="module", params=["scan", "unrolled"])
def port_run(request, jax_run, tmp_path_factory):
    cfg = dict(model=dict(TINY, **CODEFORMER), allow_no_lpips=True,
               optimizer="adafactor", grad_accum=ACCUM,
               grad_accum_mode=request.param, lr=LR, warmup_steps=WARMUP,
               grad_clip=CLIP, lmbda=2.0, lmbda_schedule=LMBDA_SCHEDULE,
               pix_loss_type=PIX_LOSS,
               run_dir=str(tmp_path_factory.mktemp("run")))
    tr = ptrainer.Trainer(cfg, device="cpu")
    tr.model.load_state_dict(jax_run["params"], strict=True)
    assert tr.frozen == ("vae", "vqgan")
    assert isinstance(tr.state.optimizer, pstep.Adafactor)
    metrics = tr.step_fn(tr.state, {"image": torch.from_numpy(_images())},
                         noise=torch.from_numpy(jax_run["noise"]))
    assert (tr.state.step, tr.state.optimizer.count) == (1, 1)
    return dict(metrics=metrics,
                grads={n: p.grad.clone() for n, p in
                       tr.model.named_parameters() if p.grad is not None},
                params=tr.model.state_dict())


def test_stage1_step_metrics_match_jax(jax_run, port_run):
    want, got = jax_run["metrics"], port_run["metrics"]
    assert sorted(got) == sorted(want)
    for key in METRICS:
        assert abs(got[key] - want[key]) <= METRIC_REL * abs(want[key]), (
            f"{key}: port {got[key]!r}, jax {want[key]!r}")


def test_stage1_step_gradients_match_jax(jax_run, port_run):
    """The mean gradients of the two micro-batches, every tensor: the
    Codeformer's and the codec's through the distillation, the frozen VAE
    decoder's (they count in ``grad_norm``); the VAE encoder and the VQGAN
    run without autograd (zero in JAX, absent here)."""
    want = {k: v.numpy() for k, v in jax_run["grads"].items()}
    got = {k: v.numpy() for k, v in port_run["grads"].items()}
    detached = {k for k in want if k.startswith(("vae.encoder.", "vqgan."))}
    assert detached and not detached & set(got)
    assert all(not want[k].any() for k in detached)
    assert set(got) == set(want) - detached
    assert any(k.startswith("codeformer.") for k in got)
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


def test_stage1_first_update_moves_nothing(jax_run, port_run):
    """Count 0 has lr 0: every parameter bit for bit as before."""
    before, after = jax_run["params"], port_run["params"]
    assert all(torch.equal(after[n], before[n]) for n in before)
