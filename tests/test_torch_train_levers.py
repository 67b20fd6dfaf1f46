"""The levers of ``configs/train_stage1.yaml`` in the port, on the CPU at the
tiny width: Adafactor against optax's (``onedc_tpu/train/step.py:
make_optimizer("adafactor")``) over four updates from count 0, leaves in
both layouts; rematerialisation (``utils/remat.py``): gradients bit-equal
to the plain forward's, the kernels' forwards launched again in the
backward, and the hazard of a generator inside the region; the trainer's
``codeformer_ckpt`` warm start against the JAX trainer's, its eval epoch's
Codeformer terms, its options, and a resumed run with Adafactor, the
Codeformer and ``grad_accum`` 2 bit for bit equal to an uninterrupted one.
The step against JAX's ``make_train_step``:
``test_torch_train_levers_step.py``.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onedc_tpu.config import Config
from onedc_tpu.train import step as jstep
from onedc_tpu.train import trainer as jtrainer
from onedc_tpu_torch.data.images import save_image
from onedc_tpu_torch.models.codeformer import Codeformer
from onedc_tpu_torch.models.onedc import OneDC
from onedc_tpu_torch.ops import conv3x3 as k2
from onedc_tpu_torch.ops import flash_attention as k1
from onedc_tpu_torch.train import losses as plosses
from onedc_tpu_torch.train import step as pstep
from onedc_tpu_torch.train import trainer as ptrainer
from onedc_tpu_torch.utils.convert import state_dict_from_jax
from onedc_tpu_torch.utils.remat import rematerialized
from torch_golden import runtime_reference
from torch_port_common import (  # noqa: F401  (a fixture)
    CODEFORMER,
    TINY,
    one_torch_thread,
    port_model,
    reference_state,
    tiny_jax_model,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
log = logging.getLogger("test_torch_train_levers")

# Adafactor's parameters after each update against optax's, relative L2 of
# their change since the start: the port factors the same two logical axes
# of a leaf, but in its own layout (row and column swapped), so the two
# agree to f32 rounding, not bit for bit
ADAFACTOR_REL = 1e-5
# the eval epoch's metrics against JAX's: relative, PSNR absolute (dB), as
# test_torch_train_loop.py holds the eval epoch without the Codeformer
EVAL_REL = 1e-4
EVAL_PSNR_ABS = 1e-3
LR, WARMUP, CLIP = 1e-2, 2, 5.0


def _flax_to_port(path: str, a: np.ndarray) -> np.ndarray:
    """A leaf of the test tree in the port's layout: HWIO -> OIHW, (in,
    out) -> (out, in); "pos" (a position embedding) and biases as they
    are."""
    if path == "pos" or a.ndim == 1:
        return a
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def _port_to_flax(path: str, a: np.ndarray) -> np.ndarray:
    if path == "pos" or a.ndim == 1:
        return a
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T


# flax shapes: factored 2-D and 4-D leaves (in both layouts), one with its
# two largest axes tied, unfactored 2-D and 4-D leaves, a bias, and a
# (256, 256) position embedding (factored, one layout on both sides)
LEAVES = {"dense": (160, 192), "conv": (3, 3, 128, 144),
          "conv_tied": (3, 3, 128, 128), "small": (64, 32),
          "small_conv": (3, 3, 8, 16), "bias": (192,), "pos": (256, 256)}


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adafactor_matches_optax(weight_decay):
    """Four updates from count 0 (lr 0: without weight decay nothing
    moves, bit for bit, in both), the global-norm clip firing on the
    second and fourth; the parameters' change against optax's within
    ADAFACTOR_REL per leaf."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in LEAVES.items()}
    grads = []
    for i in range(4):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in LEAVES.items()}
        # a norm of about 7 on the odd updates (the clip at 5 fires), about
        # 0.7 on the even ones
        scale = 7.0 if i % 2 else 0.7
        norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                           for v in g.values()))
        grads.append({k: (v * (scale / norm)).astype(np.float32)
                      for k, v in g.items()})

    tx = jstep.make_optimizer(LR, WARMUP, CLIP, weight_decay=weight_decay,
                              optimizer="adafactor")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    jax_run = [params]
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        jax_run.append({k: np.asarray(v) for k, v in jp.items()})

    names = list(LEAVES)
    pp = [torch.nn.Parameter(torch.from_numpy(
        _flax_to_port(k, params[k]).copy())) for k in names]
    opt = pstep.make_optimizer(pp, LR, WARMUP, CLIP,
                               weight_decay=weight_decay,
                               optimizer="adafactor")
    assert isinstance(opt, pstep.Adafactor)
    assert [d is not None for d in opt.dims] == [
        True, True, True, False, False, False, True]
    port_run = [params]
    for g in grads:
        for k, p in zip(names, pp):
            p.grad = torch.from_numpy(np.ascontiguousarray(
                _flax_to_port(k, g[k])))
        opt.step()
        port_run.append({k: _port_to_flax(k, p.detach().numpy().copy())
                         for k, p in zip(names, pp)})
    assert opt.count == 4
    for k in names:
        if not weight_decay:
            assert np.array_equal(jax_run[1][k], params[k])
            assert np.array_equal(port_run[1][k], params[k])
        # optax's chain adds weight_decay * p after the learning rate: the
        # first update moves the parameters by that alone
        for step in (2, 3, 4) if not weight_decay else (1, 2, 3, 4):
            want = jax_run[step][k] - params[k]
            got = port_run[step][k] - params[k]
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= ADAFACTOR_REL, (k, step, err)


def test_adafactor_matches_optax_on_the_stage1_models_leaves():
    """Every trainable leaf of the tiny stage-I model with the Codeformer
    (codec, UNet, Codeformer; converted by ``state_dict_from_jax``), two
    updates of seeded gradients from count 0: the second update against
    optax's within ADAFACTOR_REL per leaf."""
    tree = {k: v for k, v in tiny_jax_model(codeformer=True)[1][
        "params"].items() if k not in ("vae", "vqgan")}
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape)
                                     ).astype(np.float32), tree)
             for _ in range(2)]
    tx = jstep.make_optimizer(LR, 1, CLIP, optimizer="adafactor")
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jp))
    start = state_dict_from_jax(tree)
    names = sorted(start)
    params = [torch.nn.Parameter(start[n].clone()) for n in names]
    opt = pstep.Adafactor(params, LR, 1, CLIP)
    for g in grads:
        g = state_dict_from_jax(g)
        for n, p in zip(names, params):
            p.grad = g[n]
        opt.step()
    assert sum(d is not None for d in opt.dims) > 0
    bad = []
    for n, p in zip(names, params):
        d_want = (want[n] - start[n]).numpy()
        err = np.linalg.norm((p.detach() - start[n]).numpy() - d_want) \
            / np.linalg.norm(d_want)
        if not err <= ADAFACTOR_REL:
            bad.append((err, n))
    assert bad == []


def test_factored_dims_and_optimizer_choice():
    """``factored_dims`` is optax's ``_factored_dims`` (ties included);
    ``make_optimizer`` builds AdamW or Adafactor and raises on any other
    name."""
    from optax._src.factorized import _factored_dims

    for shape in [(3, 3, 128, 128), (128, 128, 3, 3), (160, 192), (192, 160),
                  (64, 32), (256, 1, 3, 3), (320,), (3, 3, 4, 320),
                  (1024, 256), (127, 300)]:
        assert pstep.factored_dims(shape) == _factored_dims(shape, True, 128)
    p = [torch.nn.Parameter(torch.zeros(4))]
    assert isinstance(pstep.make_optimizer(p), pstep.AdamW)
    with pytest.raises(ValueError, match="unknown optimizer"):
        pstep.make_optimizer(p, optimizer="sgd")


def _codeformer_model(seed: int = 0) -> OneDC:
    torch.manual_seed(seed)
    return OneDC(**TINY, **CODEFORMER)


def _images(seed: int, n: int = 2, size: int = 128) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32))


class _NoUpdate:
    count = 0

    def step(self):
        pass


def _step_grads(model, remat: bool, images, accum: int = 1):
    """One stage-I step's metrics and gradients (an optimizer that applies
    nothing), the noise from a generator seeded alike."""
    gen = torch.Generator()
    gen.manual_seed(5)
    state = pstep.TrainState(model, _NoUpdate(), ("vae", "vqgan"))
    step = pstep.make_train_step(plosses.RDLoss(), accum, remat=remat)
    metrics = step(state, {"image": images}, generator=gen)
    return metrics, {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}


def test_remat_gradients_equal_the_plain_forwards(monkeypatch):
    """The tiny stage-I model with the Codeformer, the noise from a
    generator: with remat every gradient and metric equals the plain
    forward's bit for bit, and the VAE decoder's K2 forwards run twice (the
    recompute) while its K3 input gradients run once; the frozen VAE
    encoder and VQGAN keep no gradient."""
    calls = {"k2": 0, "k3": 0}
    k2_forward = k2.AffineSiluConv3x3.forward
    k3 = k2.conv3x3_dx

    def counted_k2(ctx, *args):
        calls["k2"] += 1
        return k2_forward(ctx, *args)

    def counted_k3(g, w):
        calls["k3"] += 1
        return k3(g, w)

    monkeypatch.setattr(k2.AffineSiluConv3x3, "forward",
                        staticmethod(counted_k2))
    monkeypatch.setattr(k2, "conv3x3_dx", counted_k3)
    model = _codeformer_model()
    images = _images(1)
    runs = {}
    for remat in (False, True):
        calls.update(k2=0, k3=0)
        runs[remat] = (*_step_grads(model, remat, images), dict(calls))
    (m0, g0, c0), (m1, g1, c1) = runs[False], runs[True]
    assert m0 == m1
    assert sorted(g0) == sorted(g1)
    assert [n for n in g0 if not torch.equal(g0[n], g1[n])] == []
    assert not any(n.startswith(("vae.encoder.", "vqgan.")) for n in g0)
    assert any(n.startswith("codeformer.") for n in g0)
    assert c0 == {"k2": 28, "k3": 28} and c1 == {"k2": 56, "k3": 28}


def test_remat_launches_attention_again():
    """K1's autograd function in a remat region: its forward runs again in
    the backward (K1 f32 launches twice on the card, K1-bwd once), and the
    gradients equal the plain region's bit for bit."""
    rng = np.random.default_rng(2)
    qkv = [torch.from_numpy(rng.standard_normal((1, 256, 2, 8)).astype(
        np.float32)) for _ in range(3)]
    calls = []
    forward = k1.FlashAttention.forward

    def attend(*t):
        return (k1.flash_attention(*t, 0.35) ** 2).sum()

    grads = []
    try:
        k1.FlashAttention.forward = staticmethod(
            lambda ctx, *a: calls.append(1) or forward(ctx, *a))
        for remat in (False, True):
            ts = [t.clone().requires_grad_() for t in qkv]
            calls.clear()
            out = rematerialized(attend, *ts) if remat else attend(*ts)
            out.backward()
            grads.append(([t.grad for t in ts], len(calls)))
    finally:
        k1.FlashAttention.forward = forward
    (plain, n_plain), (remat, n_remat) = grads
    assert (n_plain, n_remat) == (1, 2)
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))


def test_a_generator_inside_a_remat_region_recomputes_other_noise():
    """Why the codec's noise is drawn before the region: checkpointing
    restores the global RNG for the recompute, not an explicit generator,
    so noise drawn inside from a generator differs in the recompute and
    the gradient (the noise itself, here) is silently wrong; the same
    draw from the global RNG, or noise passed in, is right."""
    x = torch.ones(64, requires_grad=True)

    def from_generator(v, gen):
        return (v * torch.rand(v.shape, generator=gen)).sum()

    gen = torch.Generator()
    gen.manual_seed(0)
    want = torch.rand(64, generator=gen)
    gen.manual_seed(0)
    rematerialized(from_generator, x, gen).backward()
    assert not torch.equal(x.grad, want)

    x.grad = None
    torch.manual_seed(3)
    want = torch.rand(64)
    torch.manual_seed(3)
    rematerialized(lambda v: (v * torch.rand(v.shape)).sum(), x).backward()
    assert torch.equal(x.grad, want)

    x.grad = None
    rematerialized(lambda v, n: (v * n).sum(), x, want).backward()
    assert torch.equal(x.grad, want)


def test_grad_accum_needs_a_divisible_batch():
    model = _codeformer_model()
    state = pstep.TrainState(model, _NoUpdate(), ("vae", "vqgan"))
    with pytest.raises(ValueError, match="not divisible by grad_accum 2"):
        pstep.make_train_step(grad_accum=2)(state, {"image": _images(0, 3)})
    with pytest.raises(ValueError, match="grad_accum must be >= 1"):
        pstep.make_train_step(grad_accum=0)


@pytest.mark.parametrize("key,value", [
    ("optimizer", "adafactor"), ("grad_accum", 2),
    ("model", dict(TINY, **CODEFORMER))])
def test_stage1_options_build(tmp_path, key, value):
    """The options the port once refused now build their trainer: the
    optimizer, the accumulation (batches rounded down to a multiple of
    it), the Codeformer with ``frozen`` defaulting to [vae, vqgan]; remat
    on by default, as in the JAX trainer."""
    cfg = {"model": dict(TINY), "allow_no_lpips": True,
           "run_dir": str(tmp_path / "run"), "batch_size": 3, key: value}
    tr = ptrainer.Trainer(cfg, device="cpu",
                          batches=iter([{"image": np.zeros(
                              (3, 64, 64, 3), np.float32)}] * 2))
    if key == "optimizer":
        assert isinstance(tr.state.optimizer, pstep.Adafactor)
    elif key == "grad_accum":
        assert tr.grad_accum == 2
        assert tr._prepare_batch(next(tr.train_iter), 0)["image"].shape[0] \
            == 2
        for bad in ({"grad_accum_mode": "fused"}, {"optimizer": "sgd"}):
            with pytest.raises(ValueError):
                ptrainer.Trainer({**cfg, **bad}, device="cpu")
    else:
        assert isinstance(tr.model.codeformer, Codeformer)
        assert tr.frozen == ("vae", "vqgan")


def test_codeformer_warm_start_matches_jax():
    """``codeformer_ckpt`` (a reference-named state dict) over the tiny
    Codeformer model: the port's model equals the JAX trainer's ported
    tree bit for bit, every tensor; an incomplete one raises in both."""
    jparams = tiny_jax_model(codeformer=True)[1]
    donor = Codeformer(TINY["context_dim"], 1024,
                       CODEFORMER["codeformer_window"])
    with torch.no_grad():
        for p in donor.parameters():
            p.add_(0.5)
    ckpt = reference_state(donor, "codeformer")
    want = state_dict_from_jax(jtrainer.load_part_ckpts(
        jparams, Config.wrap(dict(codeformer_ckpt=ckpt)), log))
    model = ptrainer.load_part_ckpts(port_model(codeformer=True),
                                     dict(codeformer_ckpt=ckpt), log)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
    assert all(torch.equal(got[f"codeformer.{k}"], v)
               for k, v in donor.state_dict().items())

    dropped = dict(ckpt)
    dropped.pop("mlp_head.6.bias")
    with pytest.raises(KeyError, match="does not cover"):
        jtrainer.load_part_ckpts(jparams, Config.wrap(dict(
            codeformer_ckpt=dropped)), log)
    with pytest.raises(KeyError, match="does not cover"):
        ptrainer.load_part_ckpts(port_model(codeformer=True),
                                 dict(codeformer_ckpt=dropped), log)


# the eval epoch's lambda schedule and Codeformer weights
EVAL_SCHEDULE = dict(start_step=0, end_step=10, start_value=0.5,
                     end_value=2.0)
EVAL_WEIGHTS = dict(codeformer_loss_weight=0.5, codeformer_mse_weight=2.0)


class _Writer:
    def __init__(self):
        self.images = []

    def log_image(self, tag, image, step):
        self.images.append((tag, np.asarray(image).shape, step))

    def log_dict(self, metrics, step, prefix=""):
        pass

    def flush(self):
        pass


def _folder(path, n, h, w, seed=0):
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        save_image(rng.uniform(-1, 1, (h, w, 3)).astype(np.float32),
                   path / f"im{i:02d}.png")
    return path


def _cfg_args(run_dir, data, *extra):
    model = {f"model.{k}": v for k, v in {**TINY, **CODEFORMER}.items()}
    args = dict(device="cpu", run_dir=str(run_dir),
                train_data=str(data / "train"), eval_data=str(data / "eval"),
                fsdp=False, allow_no_lpips=True, batch_size=2,
                resolutions=[128], batch_scales=[1.0], warmup_steps=1,
                lr=1e-3, grad_accum=2, save_interval=2, log_interval=1,
                max_checkpoint=1, **model)
    return ["--config", "configs/train_stage1.yaml"] + [
        f"{k}={list(v) if isinstance(v, tuple) else v}"
        for k, v in args.items()] + list(extra)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    _folder(root / "train", 3, 140, 150)
    # cut to 128x128 by the eval epoch: the Codeformer's window divides
    # its 4x4 grid
    _folder(root / "eval", 1, 130, 140, seed=1)
    return root


def test_eval_epoch_adds_the_codeformer_terms(tmp_path, data):
    """Both trainers' ``eval_one_epoch`` with the Codeformer on the same
    weights and image (130x140, cut to 128x128), the lambda schedule read at
    step 3, and the Codeformer weights read from the config
    (``onedc_tpu/train/trainer.py:272-284``): every metric within EVAL_REL
    of JAX's, ``total_loss`` and ``codeformer_loss`` included, the same
    images logged. The port's trainer is a whole one, built from the
    config; JAX's gets its parts set by hand."""
    # the JAX trainer's eval epoch on the same folder and weights (its
    # parts set by hand, the loss and weights below), stored
    gold = runtime_reference.load("evals")
    want = {k[len("levers/metrics/"):]: float(v) for k, v in gold.items()
            if k.startswith("levers/metrics/")}
    jax_images = [(t, tuple(shape), step) for t, shape, step in json.loads(
        runtime_reference.text(gold, "levers/images"))]

    cfg = dict(model=dict(TINY, **CODEFORMER), allow_no_lpips=True,
               eval_data=str(data / "eval"), run_dir=str(tmp_path / "run"),
               lmbda=2.0, lmbda_schedule=EVAL_SCHEDULE, **EVAL_WEIGHTS)
    pt = ptrainer.Trainer(cfg, device="cpu")
    pt.model.load_state_dict(port_model(codeformer=True).state_dict())
    pt.writer = _Writer()
    got = pt.eval_one_epoch(3)

    assert {"total_loss", "codeformer_loss"} <= set(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "psnr":
            assert abs(got[k] - v) <= EVAL_PSNR_ABS, (k, got[k], v)
        else:
            assert abs(got[k] - v) <= EVAL_REL * abs(v), (k, got[k], v)
    assert pt.writer.images == jax_images == [
        ("eval/recon", (128, 128, 3), 3), ("eval/gt", (128, 128, 3), 3)]


def test_resume_with_adafactor_equals_an_uninterrupted_run(tmp_path, data):
    """``main`` on the yaml (Adafactor, the Codeformer, frozen [vae,
    vqgan], remat) with ``grad_accum`` 2 to step 3 in one run, and to step
    2 then ``--resume`` to 3 in a fresh trainer: every parameter and
    Adafactor tensor bit for bit, the step and the count."""
    def state(trainer):
        tensors, meta = trainer.checkpoint_state()
        return {k: v.clone() for k, v in tensors.items()}, meta

    whole = ptrainer.main(_cfg_args(tmp_path / "whole", data,
                                    "total_steps=3"))
    assert isinstance(whole.state.optimizer, pstep.Adafactor)
    assert whole.frozen == ("vae", "vqgan") and whole.grad_accum == 2
    want, want_meta = state(whole)
    assert want_meta == {"train_step": "3", "adafactor_count": "3"}
    kinds = {k.split("/")[1] for k in want if k.startswith("adafactor/")}
    assert kinds == {"v", "v_row", "v_col"}
    assert not any(k.startswith("adamw/") for k in want)

    cut = tmp_path / "cut"
    ptrainer.main(_cfg_args(cut, data, "total_steps=2"))
    got, meta = state(ptrainer.main(_cfg_args(cut, data, "total_steps=3",
                                              "--resume")))
    assert meta == want_meta
    assert sorted(got) == sorted(want)
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
