"""The port's ``Trainer`` on the CPU at the tiny width (moved out of
``test_torch_train_step.py``, whose module fixture runs the JAX step for
minutes: under ``--dist loadfile`` a file runs on one worker, so this
test now runs beside it)."""

import numpy as np
import torch

from torch_port_common import TINY


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
