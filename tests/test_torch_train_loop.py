"""The port's stage-I training loop against the JAX package's, on the CPU
at the tiny width: the loader's batch order (``data/datasets.py``), the
checkpoint rotation and best copy (``utils/checkpoint.py``), the config
snapshot, the warm starts (``load_part_ckpts``), the eval epoch's metrics,
the resume overrides and the preemption guard (``utils/preempt.py``, the
port's copies of ``tests/test_preempt.py``), ``train/ema.py``; and, the
port alone, a resumed run bit for bit equal to an uninterrupted one and
``main``'s run directory.

The eval epochs are driven on ``Trainer.__new__`` instances with the
model, loss, loader and writer set by hand, as ``tests/test_preempt.py``
drives the JAX loop: the JAX ``Trainer.__init__`` would jit the whole
model's init.
"""

import importlib.util
import json
import logging
import os
import signal
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import twins
from onedc_tpu.config import Config
from onedc_tpu.data import datasets as jdata
from onedc_tpu.train import ema as jema
from onedc_tpu.train import trainer as jtrainer
from onedc_tpu.utils import checkpoint as jckpt
from onedc_tpu_torch.data import datasets as pdata
from onedc_tpu_torch.data.images import save_image
from onedc_tpu_torch.train import ema as pema
from onedc_tpu_torch.train import losses as plosses
from onedc_tpu_torch.train import trainer as ptrainer
from onedc_tpu_torch.utils import checkpoint as pckpt
from onedc_tpu_torch.utils.convert import state_dict_from_jax
from onedc_tpu_torch.utils.logging import read_metrics
from onedc_tpu_torch.utils.safetensors import load_safetensors
from torch_golden import runtime_reference
from torch_port_common import (  # noqa: F401  (a fixture)
    TINY,
    one_torch_thread,
    port_model,
    tiny_jax_model,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
log = logging.getLogger("test_torch_train_loop")

# the eval epoch's metrics against JAX's: relative, as the training step's
# (tests/test_torch_train_step.py METRIC_REL); psnr in dB, absolute
EVAL_REL = 1e-4
EVAL_PSNR_ABS = 1e-3
LMBDA_SCHEDULE = dict(start_step=0, end_step=10, start_value=0.5,
                      end_value=2.0)


def _folder(path, n, h, w, seed=0):
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        save_image(rng.uniform(-1, 1, (h, w, 3)).astype(np.float32),
                   path / f"im{i:02d}.png")
    return path


# -- datasets ----------------------------------------------------------------

@pytest.mark.parametrize("skip", [0, 3, 8])
def test_loader_order_matches_jax(tmp_path, skip):
    """``DataLoader`` (shuffled by ``default_rng(seed + epoch)``, the last
    partial batch dropped) and ``cycle(skip)``: the same names, in the
    same batches, over three epochs, and the same pixels."""
    root = _folder(tmp_path / "imgs", 7, 8, 12)
    jl = jdata.DataLoader(jdata.ImageFolderDataset(root), 2, shuffle=True,
                          seed=3)
    pl = pdata.DataLoader(pdata.ImageFolderDataset(root), 2, shuffle=True,
                          seed=3)
    assert len(pl) == len(jl) == 3
    ji, pi = jdata.cycle(jl, skip), pdata.cycle(pl, skip)
    for _ in range(3 * len(jl)):
        want, got = next(ji), next(pi)
        assert got["name"] == want["name"]
        assert got["caption"] == want["caption"]
        assert np.array_equal(got["image"], want["image"])


def test_datasets_match_jax(tmp_path):
    """``SimpleImageText``, ``ConcatDataset``, ``center_crop`` and the
    ``transform`` argument of ``ImageFolderDataset``."""
    root = _folder(tmp_path / "imgs", 3, 20, 30)
    paths = sorted(root.iterdir())
    caps = ["a", "b", "c"]
    crop = lambda a: jdata.center_crop(a, 16)  # noqa: E731
    pcrop = lambda a: pdata.center_crop(a, 16)  # noqa: E731
    jds = jdata.ConcatDataset([jdata.SimpleImageText(paths, caps, crop),
                               jdata.ImageFolderDataset(root, crop)])
    pds = pdata.ConcatDataset([pdata.SimpleImageText(paths, caps, pcrop),
                               pdata.ImageFolderDataset(root, pcrop)])
    assert len(pds) == len(jds) == 6
    for i in range(6):
        want, got = jds[i], pds[i]
        assert got["name"] == want["name"]
        assert got["caption"] == want["caption"]
        assert got["image"].shape == (16, 16, 3)
        assert np.array_equal(got["image"], want["image"])
    with pytest.raises(ValueError):
        pdata.SimpleImageText(paths, caps[:2])


# -- checkpoints -------------------------------------------------------------

SAVES = [(1, 3.0), (2, 2.0), (3, None), (4, 2.5), (5, 1.0), (6, 1.5)]


def test_checkpoint_rotation_and_best_match_jax(tmp_path):
    """The same save sequence with ``max_checkpoints`` 2: the same
    directories, the same latest step, the best copy from the same step."""
    jm = jckpt.CheckpointManager(tmp_path / "jax", 2)
    pm = pckpt.CheckpointManager(tmp_path / "port", 2)
    for step, metric in SAVES:
        jm.save({"x": np.full(3, step, np.float32)}, step, metric)
        pm.save({"x": torch.full((3,), float(step))}, step, metric)
        assert sorted(os.listdir(tmp_path / "port")) == \
            sorted(os.listdir(tmp_path / "jax"))
        assert pm.latest_step() == jm.latest_step()
        assert pm.best_metric == jm.best_metric
    best_j = jm._ckptr.restore((jm.best_dir).absolute(),
                               {"x": np.zeros(3, np.float32)})
    best_p = load_safetensors(pm.best_dir / pckpt.STATE_FILE)
    assert best_p["x"].numpy().tolist() == np.asarray(best_j["x"]).tolist() \
        == [5.0] * 3
    path = pm.run_dir / f"{pckpt.CKPT_PREFIX}000006"
    assert pckpt.parse_step_from_path(path) == \
        jckpt.parse_step_from_path(path) == 6
    with pytest.raises(ValueError):
        pckpt.parse_step_from_path(tmp_path)


def test_checkpoint_restores_in_place_bit_for_bit(tmp_path):
    """``restore`` copies into the live tensors: same bits, dtype and
    memory layout (a permuted view stays one); a missing name or another
    dtype raises; no checkpoint raises."""
    gen = torch.Generator().manual_seed(0)
    live = {"a": torch.randn(4, 5, generator=gen),
            "b": torch.randn(3, 2, 2, 3, generator=gen).permute(3, 2, 0, 1),
            "c": torch.randn(6, generator=gen).to(torch.bfloat16)}
    saved = {k: v.clone() for k, v in live.items()}
    mgr = pckpt.CheckpointManager(tmp_path, 1)
    with pytest.raises(FileNotFoundError):
        mgr.restore(live)
    mgr.save(live, 7, metadata={"k": "v"})
    strides = {k: v.stride() for k, v in live.items()}
    for v in live.values():
        v.zero_()
    meta, step = mgr.restore(live)
    assert step == 7 and meta == {"k": "v"}
    for k, v in live.items():
        assert v.dtype == saved[k].dtype and v.stride() == strides[k]
        assert torch.equal(v, saved[k])
    with pytest.raises(KeyError):
        mgr.restore({"a": live["a"]})
    with pytest.raises(ValueError):
        mgr.restore({**live, "a": live["a"].double()})


def test_ema_matches_jax():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    new = {k: v + 1 for k, v in params.items()}
    want = jema.ema_update(jema.ema_init(params), new, decay=0.9)
    got = pema.ema_update(pema.ema_init(
        {k: torch.from_numpy(v) for k, v in params.items()}),
        {k: torch.from_numpy(v) for k, v in new.items()}, decay=0.9)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# -- the trainer's pieces ----------------------------------------------------

def test_config_snapshot_matches_jax(tmp_path):
    cfg = dict(lmbda=2.9, resolutions=[64, 128], frozen=("vae",),
               model=dict(TINY), lmbda_schedule=dict(LMBDA_SCHEDULE),
               codec_ckpt={"w": np.zeros(2, np.float32)}, run_dir=None)
    jtrainer.save_config_snapshot(Config.wrap(cfg), tmp_path / "jax")
    ptrainer.save_config_snapshot(cfg, tmp_path / "port")
    want = (tmp_path / "jax" / "config.yaml").read_bytes()
    assert (tmp_path / "port" / "config.yaml").read_bytes() == want
    assert yaml.safe_load(want)["codec_ckpt"] == {"w": "<ndarray>"}


def _tiny_twins():
    return (twins.sd_unet_twin(in_ch=TINY["ctrl_ch"],
                               block_channels=TINY["sd_block_channels"],
                               context_dim=TINY["context_dim"]),
            twins.codec_twin(ctrl_ch=TINY["ctrl_ch"],
                             internal_ch=TINY["internal_ch"],
                             bottleneck_ch=TINY["bottleneck_ch"],
                             unet_ch_config=TINY["unet_ch_config"]))


def test_load_part_ckpts_matches_jax():
    """``codec_ckpt`` and ``unet_ckpt_lora`` (in-memory twins) over the
    tiny weights: the port's model equals JAX's ported tree bit for bit,
    every tensor; an incomplete codec raises in both; no keys, no
    change; ``codeformer_ckpt`` on a model without a Codeformer raises in
    both (the warm start itself: ``tests/test_torch_train_levers.py``)."""
    unet, codec = _tiny_twins()
    cfg = dict(codec_ckpt=codec, unet_ckpt_lora=unet)
    want = state_dict_from_jax(jtrainer.load_part_ckpts(
        tiny_jax_model()[1], Config.wrap(cfg), log))
    model = ptrainer.load_part_ckpts(port_model(), cfg, log)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
    before = port_model().state_dict()
    assert not torch.equal(before["codec.enc.pix_emb.weight"],
                           got["codec.enc.pix_emb.weight"])

    dropped = dict(codec)
    dropped.pop(next(iter(dropped)))
    with pytest.raises(KeyError, match="does not cover"):
        jtrainer.load_part_ckpts(tiny_jax_model()[1],
                                 Config.wrap(dict(codec_ckpt=dropped)), log)
    with pytest.raises(KeyError, match="does not cover"):
        ptrainer.load_part_ckpts(port_model(), dict(codec_ckpt=dropped), log)
    model = port_model()
    assert ptrainer.load_part_ckpts(model, {}, log) is model
    # a Codeformer state dict for a model without one: no home in either
    cf = {"mlp_head.6.bias": np.zeros(4, np.float32)}
    with pytest.raises(KeyError, match="no home"):
        jtrainer.load_part_ckpts(tiny_jax_model()[1],
                                 Config.wrap(dict(codeformer_ckpt=cf)), log)
    with pytest.raises(KeyError, match="no home"):
        ptrainer.load_part_ckpts(model, dict(codeformer_ckpt=cf), log)


class _Writer:
    def __init__(self):
        self.images, self.dicts = [], []

    def log_image(self, tag, image, step):
        self.images.append((tag, np.asarray(image).shape, step))

    def log_dict(self, metrics, step, prefix=""):
        self.dicts.append((prefix, step, dict(metrics)))

    def flush(self):
        pass


def test_eval_one_epoch_matches_jax(tmp_path):
    """Both trainers' ``eval_one_epoch`` over the same folder (two 80x140
    images, cut to 64x128, ``eval_max_images`` 2 of 3) on the same
    weights, with the lambda schedule read at step 7: every metric within
    EVAL_REL, the same images logged."""
    root = _folder(tmp_path / "eval", 3, 80, 140, seed=5)
    cfg = dict(eval_max_images=2)
    # the JAX trainer's eval epoch on the same folder and weights (its
    # parts set by hand: this config, the loss below), stored
    gold = runtime_reference.load("evals")
    want = {k[len("loop/metrics/"):]: float(v) for k, v in gold.items()
            if k.startswith("loop/metrics/")}
    jax_images = [(t, tuple(shape), step) for t, shape, step in json.loads(
        runtime_reference.text(gold, "loop/images"))]
    jax_dicts = [tuple(d) for d in json.loads(
        runtime_reference.text(gold, "loop/dicts"))]

    pt = ptrainer.Trainer.__new__(ptrainer.Trainer)
    pt.cfg, pt.model, pt.device = cfg, port_model(), torch.device("cpu")
    pt.loss = plosses.RDLoss(lmbda=2.0, lmbda_schedule=LMBDA_SCHEDULE)
    pt.eval_loader = pdata.DataLoader(pdata.ImageFolderDataset(root), 1)
    pt.writer = _Writer()
    got = pt.eval_one_epoch(7)

    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "psnr":
            assert abs(got[k] - v) <= EVAL_PSNR_ABS, (k, got[k], v)
        else:
            assert abs(got[k] - v) <= EVAL_REL * abs(v), (k, got[k], v)
    assert pt.writer.images == jax_images == [
        ("eval/recon", (64, 128, 3), 7), ("eval/gt", (64, 128, 3), 7)]
    assert [d[:2] for d in pt.writer.dicts] == jax_dicts == [("eval", 7)]
    assert ptrainer.Trainer.eval_one_epoch(
        SimpleNamespace(eval_loader=None), 1) == {}


# -- resume, preemption and main ---------------------------------------------

def _main_argv(run_dir, data, *extra):
    m = TINY
    return ["--config", "configs/train_stage1.yaml", "device=cpu",
            f"run_dir={run_dir}", f"train_data={data / 'train'}",
            f"eval_data={data / 'eval'}", "optimizer=adamw", "fsdp=false",
            "frozen=[vae]", "model.use_codeformer=false",
            f"model.internal_ch={m['internal_ch']}",
            f"model.bottleneck_ch={m['bottleneck_ch']}",
            f"model.unet_ch_config={list(m['unet_ch_config'])}",
            f"model.ctrl_ch={m['ctrl_ch']}",
            f"model.sd_block_channels={list(m['sd_block_channels'])}",
            f"model.context_dim={m['context_dim']}",
            f"model.vae_block_channels={list(m['vae_block_channels'])}",
            f"model.vae_attn_patch={m['vae_attn_patch']}",
            "allow_no_lpips=true", "batch_size=2", "resolutions=[64]",
            "batch_scales=[1.0]", "warmup_steps=1", "lr=1e-4",
            "save_interval=2", "log_interval=1", "max_checkpoint=1",
            *extra]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    _folder(root / "train", 5, 80, 80)
    _folder(root / "eval", 2, 70, 130, seed=1)
    return root


def _state(trainer):
    tensors, meta = trainer.checkpoint_state()
    return {k: v.clone() for k, v in tensors.items()}, meta


def test_resume_equals_an_uninterrupted_run(tmp_path, data):
    """``main`` to step 3 in one run, and to step 2 then ``--resume`` to
    3 in a fresh trainer: every parameter and AdamW moment bit for bit,
    the step and count. The uninterrupted run leaves the run directory:
    the config snapshot, the step-2 checkpoint and the best copy, the
    metrics (train every step with ``sec_per_step``, eval at 2), the eval
    images and the TensorBoard events."""
    whole = tmp_path / "whole"
    want, want_meta = _state(ptrainer.main(
        _main_argv(whole, data, "total_steps=3")))
    assert want_meta == {"train_step": "3", "adamw_count": "3"}
    # TensorBoard events under tb where the tensorboard package imports
    tb = ["tb"] if importlib.util.find_spec("tensorboard") else []
    assert sorted(os.listdir(whole)) == sorted([
        "checkpoint_model_000002", "checkpoints_best", "config.json",
        "config.yaml", "images", "metrics.jsonl"] + tb)
    assert sorted(os.listdir(whole / "images")) == [
        "eval_gt_000002.png", "eval_recon_000002.png"]
    rows = read_metrics(whole)
    assert [(r["step"], sorted({k.split("/")[0] for k in r} - {"step"}))
            for r in rows] == [(1, ["train"]), (2, ["train"]), (2, ["eval"]),
                               (2, ["checkpoint"]), (3, ["train"])]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert all(r["train/sec_per_step"] > 0 for r in rows
               if "train/pix" in r)
    assert rows[3]["checkpoint/bytes"] == \
        (whole / "checkpoint_model_000002" / "state.safetensors").stat().st_size
    assert rows[3]["checkpoint/save_s"] > 0
    snap = yaml.safe_load((whole / "config.yaml").read_text())
    assert snap["total_steps"] == 3 and snap["model"]["ctrl_ch"] == 32

    cut = tmp_path / "cut"
    ptrainer.main(_main_argv(cut, data, "total_steps=2"))
    resumed = ptrainer.main(_main_argv(cut, data, "total_steps=3",
                                       "--resume"))
    got, meta = _state(resumed)
    assert meta == want_meta
    assert sorted(got) == sorted(want)
    assert [k for k in want if not torch.equal(got[k], want[k])] == []
    # the resumed run restored step 2 and trained step 2 -> 3 only
    rows = read_metrics(cut)
    assert [r["step"] for r in rows[-2:]] == [2, 3]
    assert rows[-2]["checkpoint/restore_s"] > 0 and "train/pix" in rows[-1]


def test_resume_overrides(tmp_path):
    """``override_lr``: a fresh optimizer at the new lr (moments zero,
    count 0) at the checkpoint's step; ``override_step`` rewrites the step
    (``tests/test_trainer.py::test_config_snapshot_and_resume_overrides``
    on the JAX trainer)."""
    cfg = dict(model=dict(TINY), allow_no_lpips=True, lmbda=2.9,
               warmup_steps=1, run_dir=str(tmp_path / "run"))
    tr = ptrainer.Trainer(cfg, device="cpu")
    assert (tmp_path / "run" / "config.yaml").exists()
    tr.state.step = 5
    tr.state.optimizer.count = 5
    for mu in tr.state.optimizer.mu:
        mu.fill_(1.0)
    tr.save_checkpoint(5)

    tr2 = ptrainer.Trainer(cfg, device="cpu")
    assert tr2.resume() == 5
    assert (tr2.state.step, tr2.state.optimizer.count) == (5, 5)
    assert all(bool((mu == 1).all()) for mu in tr2.state.optimizer.mu)

    tr3 = ptrainer.Trainer({**cfg, "override_step": 11,
                            "override_lr": 1e-6}, device="cpu")
    tr3.resume()
    opt = tr3.state.optimizer
    assert tr3.state.step == 11 and opt.count == 0 and opt.lr == 1e-6
    assert all(not t.any() for t in opt.mu + opt.nu)
    assert [p.data_ptr() for p in opt.params] == \
        [p.data_ptr() for _, p in ptrainer.split_frozen(
            tr3.model, tr3.frozen)[0]]


@pytest.mark.parametrize("key,value", [("fsdp", True), ("multihost", True)])
def test_unported_options_raise(tmp_path, key, value):
    """``fsdp`` and ``multihost``, which used to raise here, are ported: in
    one process ``fsdp`` shards the trainable parameters over a mesh of
    one (``parallel/fsdp.py``; the group is left as found), and
    ``multihost`` builds the trainer as without it (torchrun's environment,
    absent here, is what joins processes). ``loader: grain``, the last
    option that raised, is ported too (``test_torch_worker_loader.py``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    cfg = {"model": dict(TINY), "allow_no_lpips": True,
           "run_dir": str(tmp_path / "run"), key: value}
    assert not dist.is_initialized()
    try:
        tr = ptrainer.Trainer(cfg, device="cpu")
        # the small trainable tensors stay replicated (``spec_for``)
        sharded = [isinstance(p, DTensor) for p in tr.state.optimizer.params]
        assert any(sharded) == (key == "fsdp")
        assert (tr.mesh is not None) == (key == "fsdp")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_guard_sets_flag_and_restores_handlers():
    from onedc_tpu_torch.utils.preempt import PreemptionGuard

    old_term = signal.getsignal(signal.SIGTERM)
    old_usr1 = signal.getsignal(signal.SIGUSR1)
    with PreemptionGuard() as g:
        assert not g.triggered
        os.kill(os.getpid(), signal.SIGUSR1)
        assert g.triggered
    assert signal.getsignal(signal.SIGTERM) is old_term
    assert signal.getsignal(signal.SIGUSR1) is old_usr1


def _stub_trainer(save_interval, signal_at, saves):
    tr = ptrainer.Trainer.__new__(ptrainer.Trainer)
    tr.total_steps = 100
    tr.log_interval = 10_000
    tr.save_interval = save_interval
    tr.state = SimpleNamespace(step=0)
    tr.train_loader = None
    tr.eval_one_epoch = lambda step: {"total_loss": 1.0}
    tr.save_checkpoint = lambda step, metric=None: saves.append(
        (step, metric))
    tr.writer = SimpleNamespace(flush=lambda: None,
                                log_dict=lambda *a, **k: None)
    steps_run = []

    def one_step(step):
        steps_run.append(step)
        if step == signal_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"total_loss": 0.0, "bpp": 0.0}

    tr.train_one_step = one_step
    return tr, steps_run


def test_trainer_loop_checkpoints_and_stops_on_signal():
    """The real ``Trainer.train`` loop on stubbed steps: SIGTERM during
    step 2 -> exactly one save, at step 3, and the loop ends."""
    saves = []
    tr, steps_run = _stub_trainer(10_000, 2, saves)
    tr.train()
    assert steps_run == [0, 1, 2]
    assert saves == [(3, None)]


def test_trainer_loop_no_double_save_when_interval_hits():
    """A signal on a save_interval step: the periodic save already ran,
    the preemption path saves no second time."""
    saves = []
    tr, steps_run = _stub_trainer(2, 1, saves)
    tr.train()
    assert steps_run == [0, 1]
    assert saves == [(2, 1.0)]
