"""Stage-II training (``onedc_tpu_torch/train/trainer_stage2.py``) over
two gloo processes on the CPU against one process, with ``fsdp: true``
and without (each turn's gradients all-reduced): a generator turn (step
0) and a latents-only step (step 1), each followed by the critic's turn,
with the yaml's remat. Metrics and gradients within
``test_torch_train_levers_step.py``'s tolerances (the rows of a global
batch of 2 and their draws split over the ranks)."""

import numpy as np
import pytest

import torch_dist
from onedc_tpu_torch.data.images import save_image
from torch_port_common import TINY, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

METRIC_REL = 1e-4
GRAD_REL_L2 = 1e-3
GRAD_FLOOR = 1e-5


def _argv(run, data, *extra):
    return ["--config", "configs/train_stage2.yaml", "device=cpu",
            f"run_dir={run}", f"train_data={data}", "allow_no_lpips=true",
            *[f"model.{k}={list(v) if isinstance(v, tuple) else v}"
              for k, v in TINY.items()],
            "guidance.block_channels=[32,32,64,64]", "guidance.context_dim=32",
            "text_encoder_config.hidden_size=32",
            "text_encoder_config.intermediate_size=64",
            "text_encoder_config.num_hidden_layers=2",
            "text_encoder_config.num_attention_heads=4",
            "batch_size=2", "dfake_gen_update_ratio=2", "warmup_steps=0",
            "gen_lr=1e-3", "guid_lr=1e-3", "save_interval=100",
            "log_interval=1", "total_steps=2", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process's, the FSDP pair's rank-0) metrics rows and gradients
    after two steps; 128x128 images (at 64x64 the UNets' deepest level is
    one pixel and the gradients are ill-conditioned,
    ``test_torch_stage2.py``)."""
    root = tmp_path_factory.mktemp("dist_stage2")
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        save_image(rng.uniform(-1, 1, (128, 128, 3)).astype(np.float32),
                   data / f"im{i}.png")
    one = torch_dist.stage2_run(0, _argv(root / "one", data))
    two = torch_dist.spawn(
        torch_dist.stage2_runs, 2, root / "spawn",
        [_argv(root / kind, data, f"fsdp={kind == 'fsdp'}")
         for kind in KINDS])[0]
    return one, dict(zip(KINDS, two))


KINDS = ("fsdp", "all-reduce")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("step", [1, 2], ids=["generator-turn",
                                              "latents-only"])
def test_stage2_step_under_fsdp_equals_one_rank(runs, step, kind):
    """Each step's metrics of both turns (the generator's at step 0, the
    critic's every step), averaged over the ranks, as one process's."""
    one, two = runs
    want = next(r for r in one["rows"] if r["step"] == step)
    got = next(r for r in two[kind]["rows"] if r["step"] == step)
    assert sorted(got) == sorted(want)
    assert ("train2/loss_dm" in want) == (step == 1)
    for k, v in want.items():
        if k.startswith("train2/") and "sec" not in k:
            assert abs(got[k] - v) <= METRIC_REL * abs(v), (k, v, got[k])


@pytest.mark.parametrize("kind", KINDS)
def test_stage2_gradients_under_fsdp_equal_one_rank(runs, kind):
    """The generator's gradients of its turn (step 0) and the critic's of
    the last step, every tensor, as one process's; the frozen parts (VAE,
    codec, real UNet) get none."""
    one, two = runs
    want, got = one["grads"], two[kind]["grads"]
    assert sorted(got) == sorted(want)
    assert not any(k.startswith(("gen/vae.", "gen/codec.", "guid/real_unet."))
                   for k in want)
    total = np.sqrt(sum(float((g ** 2).sum()) for g in want.values()))
    bad = [k for k, g in want.items() if np.linalg.norm(got[k] - g)
           > GRAD_REL_L2 * np.linalg.norm(g) + GRAD_FLOOR * total]
    assert bad == []
