"""Stage-I training over two gloo processes on the CPU against one process
(``onedc_tpu_torch/train/trainer.py`` with ``parallel/fsdp.py``): one step
under DDP and under FSDP (AdamW; Adafactor with ``grad_accum`` 2, remat
and the Codeformer), each rank's shard of the update against a plain
optimizer on the same gradients, and checkpoints that cross between an
FSDP run and a run in one process, bit for bit.

One spawned pair of processes runs every scenario (``torch_dist.
train_scenarios``: a process takes ~5 s to start); the one-process
references run here. The tolerances are ``test_torch_train_levers_step.
py``'s: metrics relative, gradients per tensor within GRAD_REL_L2 of their
norm plus GRAD_FLOOR of the global norm (a rank sums its rows' gradients in
another order than one process does)."""

import numpy as np
import pytest

import torch_dist
from onedc_tpu_torch.data.images import save_image
from onedc_tpu_torch.utils.checkpoint import STATE_FILE
from onedc_tpu_torch.utils.logging import read_metrics
from onedc_tpu_torch.utils.safetensors import load_safetensors
from torch_port_common import CODEFORMER, TINY, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

METRIC_REL = 1e-4
GRAD_REL_L2 = 1e-3
GRAD_FLOOR = 1e-5
# a rank's shard of the update against a plain optimizer on the same
# (gathered) gradients: the means and norms that cross shards are summed
# in another order
UPDATE_REL = 1e-5
IMAGE = 128


def _cfg(fsdp: bool, optimizer: str = "adamw", accum: int = 1,
         codeformer: bool = False) -> dict:
    # MSE, not L1: the L1 gradient's sign flips where two runs' predictions
    # straddle the image (``test_torch_train_step.py``)
    return dict(allow_no_lpips=True, lr=1e-3, warmup_steps=0, batch_size=4,
                resolutions=[IMAGE], seed=0, optimizer=optimizer,
                pix_loss_type="mse", fsdp=fsdp, grad_accum=accum,
                gradient_checkpointing=codeformer,
                frozen=["vae", "vqgan"] if codeformer else ["vae"],
                model=dict(TINY, **(CODEFORMER if codeformer else {})))


STEPS = {"ddp-adamw": _cfg(False),
         "fsdp-adamw": _cfg(True),
         "fsdp-adafactor-accum2-remat-codeformer": _cfg(True, "adafactor", 2,
                                                        True)}


def _batch():
    rng = np.random.default_rng(11)
    return {"image": rng.uniform(-1, 1, (4, IMAGE + 12, IMAGE + 12, 3)
                                 ).astype(np.float32)}


def _argv(run_dir, data, fsdp: bool, *extra):
    args = dict(device="cpu", run_dir=str(run_dir), train_data=str(data),
                eval_data=str(data), eval_max_images=1, fsdp=fsdp,
                allow_no_lpips=True, optimizer="adafactor", batch_size=2,
                resolutions=[IMAGE], batch_scales=[1.0], warmup_steps=0,
                lr=1e-3, pix_loss_type="mse", gradient_checkpointing=False,
                frozen=["vae"], save_interval=2, log_interval=1,
                max_checkpoint=1, total_steps=2,
                **{"model.use_codeformer": False},
                **{f"model.{k}": v for k, v in TINY.items()})
    return ["--config", "configs/train_stage1.yaml"] + [
        f"{k}={list(v) if isinstance(v, tuple) else v}"
        for k, v in args.items()] + list(extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one-process results, the spawned pair's rank-0 results, paths)."""
    from onedc_tpu_torch.train import trainer

    root = tmp_path_factory.mktemp("dist_train")
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        save_image(rng.uniform(-1, 1, (IMAGE + 8, IMAGE + 8, 3)).astype(
            np.float32), data / f"im{i}.png")
    one = {name: torch_dist.one_step(dict(cfg, fsdp=False), _batch())
           for name, cfg in STEPS.items() if name != "fsdp-adamw"}
    one["fsdp-adamw"] = one["ddp-adamw"]
    # a one-process run's checkpoint at step 2, for the ranks to resume
    trainer.main(_argv(root / "one", data, False))
    two = torch_dist.spawn(
        torch_dist.train_scenarios, 2, root / "spawn",
        {name: (cfg, _batch()) for name, cfg in STEPS.items()},
        {"resume": _argv(root / "one", data, True, "--resume"),
         "save": _argv(root / "two", data, True)})
    return one, two[0], root, data


def _assert_step_close(got: dict, want: dict):
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= METRIC_REL * abs(v), (k, v)
    grads = want["grads"]
    assert sorted(got["grads"]) == sorted(grads)
    total = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
    bad = [k for k, g in grads.items() if np.linalg.norm(
        got["grads"][k] - g) > GRAD_REL_L2 * np.linalg.norm(g)
        + GRAD_FLOOR * total]
    assert bad == []


@pytest.mark.parametrize("name", list(STEPS))
def test_step_over_two_ranks_equals_one_rank(runs, name):
    """A global batch of 4 split over two ranks (DDP, or FSDP shards):
    every metric (averaged over the ranks) and every gradient (the frozen
    VAE decoder's too, which ``grad_norm`` counts) as one process's."""
    one, two, _, _ = runs
    _assert_step_close(two[name], one[name])


@pytest.mark.parametrize("name", [n for n in STEPS if n.startswith("fsdp")])
def test_sharded_update_equals_the_plain_optimizer(runs, name):
    """Each rank's FSDP shard updated in place (AdamW; Adafactor's row and
    column moments reduced over the shards) as the plain optimizer updates
    the whole parameter from the same gradients."""
    _, two, _, _ = runs
    assert two[name]["update_err"] <= UPDATE_REL


def test_fsdp_checkpoint_resumes_one_rank_bit_for_bit(runs):
    """Two FSDP ranks (Adafactor) train two steps and write one file at
    step 2, in the one-process layout; one process resumes it: every
    parameter and optimizer tensor equal to the ranks' gathered state, and
    to the file."""
    from onedc_tpu_torch.train import trainer

    _, two, root, data = runs
    saved = load_safetensors(root / "two" / "checkpoint_model_000002" /
                             STATE_FILE)
    resumed = trainer.main(_argv(root / "two", data, False, "--resume"))
    state, meta = resumed.checkpoint_state()
    got = torch_dist.to_numpy(state)
    assert meta == two["saved_meta"] == {"train_step": "2",
                                         "adafactor_count": "2"}
    assert sorted(got) == sorted(two["saved"]) == sorted(saved)
    assert any(k.startswith("adafactor/v_row/") for k in got)
    assert [k for k in got if not np.array_equal(got[k], two["saved"][k])
            ] == []
    assert [k for k in got if not np.array_equal(
        got[k], saved[k].float().numpy())] == []


def test_one_rank_checkpoint_resumes_fsdp_ranks_bit_for_bit(runs):
    """A one-process checkpoint restored by two FSDP ranks (broadcast from
    process 0, each keeping its shard): the gathered state equals the file
    bit for bit."""
    _, two, root, _ = runs
    saved = load_safetensors(root / "one" / "checkpoint_model_000002" /
                             STATE_FILE)
    assert two["resumed_step"] == 2
    assert sorted(two["resumed"]) == sorted(saved)
    assert [k for k in saved if not np.array_equal(
        two["resumed"][k], saved[k].float().numpy())] == []


def test_only_process_zero_writes_and_runs_agree(runs):
    """The FSDP pair's run directory holds one writer's rows (as many as the
    one-process run's, the eval epoch's mean over the ranks among them);
    the first step's metrics within METRIC_REL of the one-process run's
    (later ones part further: Adafactor scales each update by the
    gradients' own size, so the ranks' rounding moves every parameter)."""
    _, _, root, _ = runs
    # the resumes append their restore rows to the directories they read
    one, two = ([r for r in read_metrics(root / d)
                 if "checkpoint/restore_s" not in r] for d in ("one", "two"))
    assert [sorted(r) for r in two] == [sorted(r) for r in one]
    assert any(k.startswith("eval/") for r in two for k in r)
    first = [(a, b) for a, b in zip(one, two) if a["step"] == 1]
    assert first
    for a, b in first:
        for k, v in a.items():
            if k.startswith("train/") and "sec" not in k:
                assert abs(b[k] - v) <= METRIC_REL * abs(v), (k, v, b[k])
