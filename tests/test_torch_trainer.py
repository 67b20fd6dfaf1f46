"""The port's ``Trainer`` on the CPU at the tiny width (moved out of
``test_torch_train_step.py``, whose module fixture runs the JAX step for
minutes: under ``--dist loadfile`` a file runs on one worker, so this
test now runs beside it)."""

import numpy as np
import pytest
import torch

from torch_port_common import TINY, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_trainer_steps_on_the_cpu():
    """``Trainer(cfg, device="cpu")`` from the stage-I keys at the tiny
    width: two steps, metrics finite, the VAE untouched, lr 0 first."""
    from onedc_tpu_torch.train.trainer import Trainer

    cfg = dict(allow_no_lpips=True, lr=1e-4, warmup_steps=2, batch_size=2,
               resolutions=[64, 128], batch_scales=[1.0, 0.5], seed=0,
               optimizer="adamw", frozen=["vae"], model=dict(TINY))
    rng = np.random.default_rng(0)
    batches = ({"image": rng.uniform(-1, 1, (2, 160, 160, 3)).astype(
        np.float32)} for _ in range(2))
    tr = Trainer(cfg, device="cpu", batches=batches)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    for step in (0, 1):
        metrics = tr.train_one_step(step)
        assert all(np.isfinite(v) for v in metrics.values())
        if step == 0:
            after = tr.model.state_dict()
            assert all(torch.equal(before[k], after[k]) for k in before)
    after = tr.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before
               if k.startswith("vae."))
    assert not all(torch.equal(before[k], after[k]) for k in before)
    assert tr.state.step == 2


def test_trainer_steps_with_lpips_on_the_cpu(tmp_path):
    """``lpips_weights`` (a converted file, seeded random weights) puts the
    LPIPS term in the loss: > 0 in every step's metrics, its VGG frozen
    outside the model (in no optimizer slot, every parameter bit-identical
    after the steps) while the model trains."""
    from onedc_tpu_torch.nn.lpips import random_lpips_weights
    from onedc_tpu_torch.train.trainer import Trainer
    from onedc_tpu_torch.utils.safetensors import save_safetensors

    path = tmp_path / "lpips.safetensors"
    save_safetensors(random_lpips_weights(0), path)
    cfg = dict(lpips_weights=str(path), lpips_weight=0.5, lr=1e-4,
               warmup_steps=1, batch_size=1, resolutions=[64], seed=0,
               model=dict(TINY))
    rng = np.random.default_rng(1)
    batches = ({"image": rng.uniform(-1, 1, (1, 96, 96, 3)).astype(
        np.float32)} for _ in range(2))
    tr = Trainer(cfg, device="cpu", batches=batches)
    vgg = {k: v.clone() for k, v in tr.lpips.state_dict().items()}
    slots = {id(p) for p in tr.state.optimizer.params}
    assert not any(id(p) in slots or p.requires_grad
                   for p in tr.lpips.parameters())
    assert not tr.lpips.training
    assert not any(k.startswith("lpips") for k in tr.model.state_dict())
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    for step in (0, 1):
        metrics = tr.train_one_step(step)
        assert all(np.isfinite(v) for v in metrics.values())
        assert metrics["lpips"] > 0
        assert metrics["weighted_lpips"] == pytest.approx(
            0.5 * metrics["lpips"], rel=1e-6)
    after = tr.lpips.state_dict()
    assert all(torch.equal(vgg[k], after[k]) for k in vgg)
    assert not all(torch.equal(before[k], v)
                   for k, v in tr.model.state_dict().items())
