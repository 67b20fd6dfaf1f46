"""Stage II in the port against the JAX package on the CPU: ``SD15UNet``,
``ClsHead``, ``SDGuidance``'s two forwards and their gradients, one turn of
each step, the eval epoch (stored JAX outputs,
``tests/torch_golden/stage2_reference.py``; ``test_torch_stage2_golden.py``
recomputes them), and the port's own rules: each turn takes only its own
gradients, CFG as one batch, the trainer through ``main`` with a
checkpoint and a bit-exact ``--resume``.

Tolerances (f32 on both sides, seeded tiny nets), relative to the largest
value: module outputs and the forwards' losses 1e-5 (measured <= 2.6e-6);
the GAN head 1e-4 (3.9e-5 with the pad: its second conv leaves a 1x1 grid,
where each GroupNorm group holds two values and the one-pass f32 variance
cancels); the losses' gradients with respect to the latents 1e-3 (1.3e-4,
through that head); the steps' metrics and latents 1e-4 (2.5e-5; the x0
recovery amplifies f32 differences by 1 / sqrt(alpha_bar(999)) ~ 14.5:
3.6e-6), on 128x128 images (at 64x64 the UNets' /64 level is one pixel and
the gradients there are ill-conditioned in either framework).
Parameter gradients per tensor as ``test_torch_train_step.py`` holds
them: ||port - jax|| <= GRAD_REL_L2 * ||jax|| + GRAD_FLOOR * (the global
norm), on the whole tensor for the head and on a digest (the norm and the
first 16 values) for the UNets: a bias's gradient is a sum over positions
that nearly cancels, so its own norm is no scale for its error.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_golden import stage2_reference as ref  # noqa: E402
from torch_port_common import TINY, one_torch_thread  # noqa: E402,F401

from onedc_tpu_torch.models.dmd import ClsHead, add_noise  # noqa: E402
from onedc_tpu_torch.train import step as pstep  # noqa: E402
from onedc_tpu_torch.train import trainer_stage2 as t2  # noqa: E402
from onedc_tpu_torch.train.losses import RDLoss  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODULE_TOL = 1e-5
HEAD_TOL = 1e-4
GRAD_TOL = 1e-3
STEP_TOL = 1e-4
GRAD_REL_L2 = 1e-3
GRAD_FLOOR = 1e-5


@pytest.fixture(scope="module")
def gold():
    return ref.load()


@pytest.fixture(scope="module")
def x():
    return {k: torch.from_numpy(v) for k, v in ref.inputs().items()}


@pytest.fixture(scope="module")
def guidance():
    return ref.port_guidance().requires_grad_(False)


def close(got, want, tol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err < tol, (what, err)


def draws(gold, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in gold.items()
            if k.startswith(prefix) and "/" not in k[len(prefix):]}


def global_norm(gold, prefix, full=()):
    """The global norm of a stored gradient: its digests' norms and the
    whole tensors ``full``."""
    return float(np.sqrt(sum(float(v) ** 2 for k, v in gold.items()
                             if k.startswith(prefix + "norm/"))
                         + sum(np.sum(gold[k].astype(np.float64) ** 2)
                               for k in full)))


def digest_close(named_grads, gold, prefix, total):
    """Each tensor's norm and first values against the stored digest, by
    the per-tensor rule with the global norm ``total``."""
    names = sorted(k[len(prefix) + 5:] for k in gold
                   if k.startswith(prefix + "norm/"))
    assert names and sorted(named_grads) == names
    for name in names:
        g = named_grads[name].detach().numpy().astype(np.float64)
        norm = float(gold[f"{prefix}norm/{name}"])
        limit = GRAD_REL_L2 * norm + GRAD_FLOOR * total
        head = gold[f"{prefix}head/{name}"]
        assert abs(np.linalg.norm(g) - norm) <= limit, name
        assert np.linalg.norm(g.reshape(-1)[:head.size] - head) <= limit, name


# -- modules ---------------------------------------------------------------

@pytest.mark.parametrize("classify", [False, True])
def test_sd15_unet_matches_jax(gold, x, guidance, classify):
    with torch.no_grad():
        out = guidance.fake_unet(x["lat"], x["t"], x["text"],
                                 classify=classify)
    close(out, gold[f"unet_classify{int(classify)}"], MODULE_TOL)


@pytest.mark.parametrize("feat", ["feat8", "feat35"])
def test_cls_head_matches_jax_with_and_without_the_pad(gold, x, guidance,
                                                       feat):
    with torch.no_grad():
        logits = guidance.cls_pred_branch(x[feat])
    assert logits.shape == (2, 1)
    close(logits, gold[f"cls_{feat}"], HEAD_TOL)


def test_cls_head_pads_a_small_grid_with_zeros():
    head = ClsHead(32).requires_grad_(False)
    rep = torch.randn(1, 32, 3, 5)
    padded = torch.zeros(1, 32, 8, 8)
    padded[:, :, :3, :5] = rep
    with torch.no_grad():
        assert torch.equal(head(rep), head(padded))


def test_add_noise_is_the_ddpm_forward(guidance):
    abar = guidance.alphas_cumprod
    x0 = torch.ones(2, 4, 2, 2)
    noise = torch.full_like(x0, 2.0)
    t = torch.tensor([0, 999])
    out = add_noise(x0, noise, t, abar)
    for i, ti in enumerate(t.tolist()):
        a = np.float32(abar[ti])
        want = np.sqrt(a) + np.sqrt(np.float32(1) - a) * 2
        assert abs(float(out[i, 0, 0, 0]) - want) < 1e-6


def test_generator_forward_matches_jax(gold, x, guidance):
    with torch.no_grad():
        out = guidance.generator_forward(x["lat"], x["text"], x["uncond"],
                                         draws=draws(gold, "gen/"))
    assert sorted(out) == sorted(k[len("gen_out/"):] for k in gold
                                 if k.startswith("gen_out/"))
    for key, value in out.items():
        close(value, gold[f"gen_out/{key}"], MODULE_TOL, key)


def test_guidance_forward_matches_jax(gold, x, guidance):
    with torch.no_grad():
        out = guidance.guidance_forward(x["lat"], x["real"], x["text"],
                                        x["uncond"], x["text"],
                                        draws=draws(gold, "guid/"))
    assert sorted(out) == sorted(k[len("guid_out/"):] for k in gold
                                 if k.startswith("guid_out/"))
    for key, value in out.items():
        close(value, gold[f"guid_out/{key}"], MODULE_TOL, key)


@pytest.mark.parametrize("term", ["loss_dm", "gen_cls_loss"])
def test_generator_loss_gradients_wrt_latents_match_jax(gold, x, guidance,
                                                        term):
    lat = x["lat"].clone().requires_grad_(True)
    out = guidance.generator_forward(lat, x["text"], x["uncond"],
                                     draws=draws(gold, "gen/"))
    (grad,) = torch.autograd.grad(out[term], lat)
    close(grad, gold[f"gen_grad/{term}"], GRAD_TOL, term)
    if term == "loss_dm":
        # the detached-target MSE: d loss / d latents = grad / N
        norm = float(out["dm_gradient_norm"])
        assert abs(float(grad.norm()) * lat.numel() - norm) < 1e-4 * norm


def test_guidance_loss_gradients_match_jax(gold, x):
    g = ref.port_guidance()
    trainable = [p for n, p in g.named_parameters()
                 if not n.startswith("real_unet.")]
    out = g.guidance_forward(x["lat"], x["real"], x["text"], x["uncond"],
                             x["text"], draws=draws(gold, "guid/"))
    loss = out["loss_fake_mean"] + 1e-2 * out["guidance_cls_loss"]
    torch.autograd.backward(loss, inputs=trainable)
    grads = {n: p.grad for n, p in g.named_parameters() if p.grad is not None}
    head = [n for n in grads if n.startswith("cls_pred_branch.")]
    total = global_norm(gold, "guid_grad/", [f"guid_grad/{n}" for n in head])
    digest_close({n: v for n, v in grads.items()
                  if n.startswith("fake_unet.")}, gold, "guid_grad/", total)
    for name in head:
        want = gold[f"guid_grad/{name}"].astype(np.float64)
        diff = np.linalg.norm(grads[name].numpy() - want)
        assert diff <= GRAD_REL_L2 * np.linalg.norm(want) \
            + GRAD_FLOOR * total, name
    assert len(head) == 10
    assert not any(n.startswith("real_unet.") for n in grads)


def test_cfg_as_one_batch_equals_its_two_forwards(x, guidance):
    """``_predict_noise`` with a scale above 1 runs uncond and text rows as
    one 2B forward; the same combination of two B forwards."""
    t = x["t"]
    with torch.no_grad():
        got = guidance._predict_noise(guidance.real_unet, x["lat"],
                                      x["text"], x["uncond"], t, 1.75)
        eu = guidance.real_unet(x["lat"], t, x["uncond"])
        et = guidance.real_unet(x["lat"], t, x["text"])
    close(got, eu + 1.75 * (et - eu), 1e-5)


# -- the two turns -----------------------------------------------------------

def stage2_pair():
    onedc = ref.port_onedc()
    guidance = ref.port_guidance()
    gen, guid = pstep.create_stage2_states(onedc, guidance, gen_lr=1e-2,
                                           guid_lr=1e-2, warmup_steps=0)
    return gen, guid


def _gen_turn(gold, x, gen, guid, remat):
    step = t2.make_generator_step(RDLoss(lmbda=0.0), remat=remat)
    return step(gen, guid.model, {"image": x["image"]}, x["text"],
                x["uncond"], noise=torch.from_numpy(gold["step/bit_noise"]),
                draws=draws(gold, "step/gen/"))


@pytest.mark.parametrize("remat", [False, True])
def test_generator_turn_matches_jax(gold, x, remat):
    gen, guid = stage2_pair()
    frozen = {n: p.clone() for n, p in gen.model.named_parameters()
              if n.split(".")[0] in ("vae", "codec")}
    metrics, aux = _gen_turn(gold, x, gen, guid, remat)
    for key, value in metrics.items():
        close(value, gold[f"step/gen_metrics/{key}"], STEP_TOL, key)
    for key in ("fake_latents", "real_latents"):
        close(aux[key], gold[f"step/{key}"], STEP_TOL, key)
    digest_close({n: p.grad for n, p in gen.model.named_parameters()
                  if n.startswith("unet.")}, gold, "step/gen_grad/",
                 global_norm(gold, "step/gen_grad/"))
    assert all(torch.equal(p, frozen[n])
               for n, p in gen.model.named_parameters() if n in frozen)
    assert gen.step == 1 and gen.optimizer.count == 1


def test_guidance_turn_matches_jax(gold, x):
    gen, guid = stage2_pair()
    real_before = {n: p.clone() for n, p in guid.model.named_parameters()
                   if n.startswith("real_unet.")}
    fake = torch.from_numpy(gold["step/fake_latents"])
    real = torch.from_numpy(gold["step/real_latents"])
    step = t2.make_guidance_step()
    metrics = step(guid, fake, real, x["text"], x["uncond"],
                   draws=draws(gold, "step/guid/"))
    assert sorted(metrics) == sorted(k.split("/")[-1] for k in gold
                                     if k.startswith("step/guid_metrics/"))
    for key, value in metrics.items():
        close(value, gold[f"step/guid_metrics/{key}"], STEP_TOL, key)
    digest_close({n: p.grad for n, p in guid.model.named_parameters()
                  if p.grad is not None}, gold, "step/guid_grad/",
                 global_norm(gold, "step/guid_grad/"))
    assert all(torch.equal(p, real_before[n])
               for n, p in guid.model.named_parameters() if n in real_before)


@pytest.mark.parametrize("turn", ["generator", "guidance"])
def test_grad_accum_is_the_mean_of_its_micro_batches(gold, x, turn):
    """``grad_accum`` 2 on a batch of two: each turn's gradients and metrics
    are the mean of the same turn run on each row alone with that row's
    draws, as JAX's ``grad_accum_scan``."""
    draws_all = draws(gold, f"step/{'gen' if turn == 'generator' else 'guid'}/")
    fake = torch.from_numpy(gold["step/fake_latents"])
    real = torch.from_numpy(gold["step/real_latents"])
    noise = torch.from_numpy(gold["step/bit_noise"])

    def run(accum, rows):
        gen, guid = stage2_pair()
        d = {k: v[rows] for k, v in draws_all.items()}
        text, uncond = x["text"][rows], x["uncond"][rows]
        if turn == "generator":
            step = t2.make_generator_step(RDLoss(lmbda=0.0),
                                          grad_accum=accum)
            metrics, _ = step(gen, guid.model, {"image": x["image"][rows]},
                              text, uncond, noise=noise[rows], draws=d)
            state = gen
        else:
            step = t2.make_guidance_step(grad_accum=accum)
            metrics = step(guid, fake[rows], real[rows], text, uncond,
                           draws=d)
            state = guid
        return metrics, [p.grad for p in state.optimizer.params]

    metrics, grads = run(2, slice(0, 2))
    halves = [run(1, slice(i, i + 1)) for i in range(2)]
    for key, value in metrics.items():
        want = (halves[0][0][key] + halves[1][0][key]) * np.float32(0.5)
        assert abs(value - want) <= 1e-6 * max(abs(want), 1e-12), key
    for g, a, b in zip(grads, halves[0][1], halves[1][1]):
        if g is None:
            assert a is None and b is None
            continue
        want = (a + b) * np.float32(0.5)
        assert torch.allclose(g, want, rtol=1e-5, atol=1e-7 * float(
            want.abs().max()) + 1e-12)


def test_turns_take_only_their_own_gradients(gold, x):
    """The generator turn's gen-cls logit runs through the fake UNet and the
    head, yet leaves their ``.grad`` empty; the guidance turn leaves the
    generator's as it was; no frozen part ever holds one."""
    gen, guid = stage2_pair()
    _, aux = _gen_turn(gold, x, gen, guid, remat=False)
    assert all(p.grad is None for p in guid.model.parameters())
    gen_grads = {n: p.grad.clone() for n, p in gen.model.named_parameters()
                 if p.grad is not None}
    assert gen_grads and all(n.startswith("unet.") for n in gen_grads)
    t2.make_guidance_step()(guid, aux["fake_latents"], aux["real_latents"],
                            x["text"], x["uncond"],
                            draws=draws(gold, "step/guid/"))
    assert all(torch.equal(p.grad, gen_grads[n])
               for n, p in gen.model.named_parameters() if n in gen_grads)
    assert all((p.grad is None) == n.startswith("real_unet.")
               for n, p in guid.model.named_parameters())
    assert not any(p.grad is not None or p.requires_grad
                   for n, p in gen.model.named_parameters()
                   if n.split(".")[0] in ("vae", "codec"))


def test_stage2_states_freeze_what_jax_freezes():
    gen, guid = stage2_pair()
    assert gen.frozen == ("vae", "codec") and guid.frozen == ("real_unet",)
    gen_names = {n.split(".")[0] for n, p in gen.model.named_parameters()
                 if p.requires_grad}
    assert gen_names == {"unet"}
    assert {n.split(".")[0] for n, p in guid.model.named_parameters()
            if p.requires_grad} == {"fake_unet", "cls_pred_branch"}
    assert len(gen.optimizer.params) == sum(
        1 for n, _ in gen.model.named_parameters() if n.startswith("unet."))
    gen2, _ = pstep.create_stage2_states(
        ref.port_onedc(), ref.port_guidance(), optimizer="adafactor")
    assert gen2.optimizer.name == "adafactor"


# -- the trainer ------------------------------------------------------------

def test_eval_one_epoch_matches_jax(gold, x, tmp_path):
    from onedc_tpu_torch.utils.logging import make_writer

    tr = t2.Stage2Trainer.__new__(t2.Stage2Trainer)
    tr.onedc = ref.port_onedc().requires_grad_(False)
    tr.device = torch.device("cpu")
    tr.rd_loss = RDLoss(lmbda=0.0)
    tr.eval_loader = [{"image": x["eval0"].numpy()},
                      {"image": x["eval1"].numpy()}]
    tr.writer = make_writer(tmp_path)
    tr.cfg = {}
    got = tr.eval_one_epoch(step=1)
    want = {k[len("eval/"):]: float(v) for k, v in gold.items()
            if k.startswith("eval/")}
    assert sorted(got) == sorted(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-4 * max(abs(want[key]),
                                                        1e-3), key
    assert sorted(os.listdir(tmp_path / "images")) == [
        "eval_gt_000001.png", "eval_recon_000001.png"]
    tr.eval_loader = None
    assert tr.eval_one_epoch(step=1) == {}


def test_round_batch_as_jax():
    imgs = np.arange(10 * 2 * 2 * 3, dtype=np.float32).reshape(10, 2, 2, 3)
    caps = [f"c{i}" for i in range(10)]
    out, oc = t2.Stage2Trainer.round_batch(imgs, caps, 8)
    assert out.shape[0] == 8 and oc == caps[:8]
    out, oc = t2.Stage2Trainer.round_batch(imgs[:4], caps[:4], 8)
    assert out.shape[0] == 8 and oc == caps[:4] * 2
    np.testing.assert_array_equal(out[4:], out[:4])
    out, oc = t2.Stage2Trainer.round_batch(imgs[:8], caps[:8], 4)
    assert out.shape[0] == 8 and oc == caps[:8]


def test_the_shipped_yaml_requires_lpips():
    """``configs/train_stage2.yaml`` ships ``lpips_weights: null``: the
    trainer raises before building anything, as JAX's does."""
    with pytest.raises(ValueError, match="lpips_weights"):
        t2.main(["--config", "configs/train_stage2.yaml", "device=cpu"])


def _folder(path, n, seed):
    from onedc_tpu_torch.data.images import save_image
    path.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        save_image(rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32),
                   path / f"im{i}.png")
    return path


def _argv(run, data, *extra):
    m = TINY
    return ["--config", "configs/train_stage2.yaml", "device=cpu",
            f"run_dir={run}", f"train_data={data / 'train'}",
            f"eval_data={data / 'eval'}", "allow_no_lpips=true",
            *[f"model.{k}={list(v) if isinstance(v, tuple) else v}"
              for k, v in m.items()],
            "guidance.block_channels=[32,32,64,64]", "guidance.context_dim=32",
            "text_encoder_config.hidden_size=32",
            "text_encoder_config.intermediate_size=64",
            "text_encoder_config.num_hidden_layers=2",
            "text_encoder_config.num_attention_heads=4",
            "batch_size=2", "dfake_gen_update_ratio=2", "warmup_steps=1",
            "gen_lr=1e-3", "guid_lr=1e-3", "save_interval=2",
            "log_interval=1", "max_checkpoint=1", *extra]


def test_main_trains_checkpoints_and_resumes_bit_for_bit(tmp_path):
    """3 steps == 2 steps + ``--resume`` + 1, every tensor of both states
    (the yaml's defaults: remat on, AdamW), with a generator turn on each
    side of the cut (``dfake_gen_update_ratio=2``: turns at steps 0, 2)."""
    from onedc_tpu_torch.utils.logging import read_metrics

    data = tmp_path / "data"
    _folder(data / "train", 3, 0)
    _folder(data / "eval", 1, 1)
    whole = t2.main(_argv(tmp_path / "whole", data, "total_steps=3"))
    want, want_meta = whole.checkpoint_state()
    want = {k: v.clone() for k, v in want.items()}
    rows = read_metrics(tmp_path / "whole")
    assert [(r["step"], "train2/loss_dm" in r) for r in rows
            if any(k.startswith("train2/") for k in r)] == [
        (1, True), (2, False), (3, True)]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert [r for r in rows if "eval2/total_loss" in r][0]["step"] == 2
    assert whole.gen_state.step == 2 and whole.guid_state.step == 3

    t2.main(_argv(tmp_path / "cut", data, "total_steps=2"))
    resumed = t2.main(_argv(tmp_path / "cut", data, "total_steps=3",
                            "--resume"))
    got, meta = resumed.checkpoint_state()
    assert sorted(got) == sorted(want)
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
    assert meta["gen_step"] == "2" and meta["guid_step"] == "3"
    assert {k.split("/")[0] for k in got} == {"gen", "guid"}
