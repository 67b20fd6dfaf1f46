"""Stage-I trainer: rate-distortion training of the codec and the one-step
generator, with its loop.

JAX counterpart: ``onedc_tpu/train/trainer.py`` (``save_config_snapshot``
:43, ``load_part_ckpts`` :65, ``Trainer`` :93 with ``_prepare_batch``,
``train_one_step``, ``eval_one_epoch`` :251, ``train`` :313, ``resume``
:373, and ``main`` :415), read from the same config keys: ``lr``,
``warmup_steps``, ``grad_clip``, ``frozen``, ``lmbda``, ``lmbda_schedule``,
``pix_weight``, ``lpips_weight``, ``pix_loss_type``, ``lpips_weights`` /
``allow_no_lpips``, ``batch_size``, ``resolutions``, ``batch_scales``,
``seed``, ``optimizer`` (``adamw`` or ``adafactor``), ``fsdp``,
``grad_accum`` with ``grad_accum_mode`` (``scan`` or ``unrolled``:
accepted only so that JAX's configs load; both are the same host loop
here and the value changes nothing), ``gradient_checkpointing`` (default true, as JAX's),
``codeformer_loss_weight`` / ``codeformer_mse_weight``, ``model``,
``train_data`` / ``eval_data`` (image folders), ``eval_max_images``,
``run_dir``, ``max_checkpoint``, ``log_interval``, ``save_interval``,
``total_steps``, ``codec_ckpt`` / ``unet_ckpt_lora`` / ``codeformer_ckpt``
and ``override_lr`` / ``override_step``. ``lpips_weights``: a converted
LPIPS file (``nn/lpips.py``), the avg-pool VGG of the reference's loss,
held frozen beside the model. ``frozen`` defaults to ``[vae, vqgan]``
with the Codeformer, else ``[vae]``.

Over several processes (``torchrun --nproc-per-node N -m
onedc_tpu_torch.train.trainer ...``; ``main`` joins the group from
torchrun's environment, and ``multihost`` asks for the same) the trainer
builds a mesh over the world (``parallel/mesh.py``). ``fsdp: true``
shards the trainable parameters, their gradients and the optimizer's
state over its ``data`` axis (``parallel/fsdp.py``; on one device a mesh
of one process); ``fsdp: false`` with more than one rank wraps the model
in DDP. Every rank draws the same global batch from the seeded loader,
rounded to a multiple of ``data x grad_accum`` (JAX :231-241), and the
codec's noise for all of it, and keeps its rows (``rank_rows``): N ranks
compute what one does. Metrics are averaged over the ranks, eval metrics
too (``reduce_mean_across_hosts``); only process 0 writes.

``loader: grain`` reads the folder with worker processes
(``data/datasets.py:make_grain_loader``, ``loader_workers`` of them, 8 by
default): each rank reads its own disjoint share of every epoch, in
batches of ``batch_size`` / ranks, and trains them as its rows of the
global batch (the noise is still drawn for the whole of it), so an epoch
trains each record once over all ranks; the loader's position is saved
beside every checkpoint (``loader_state_NNNNNN.bin``) and restored by
``resume``, as JAX ``trainer.py:356-384``.

Differences, by design:
- the worker loader's order is its own, not grain's index shuffle;
- ``batches=`` (an iterable of numpy ``{"image": (B, H, W, 3)}`` in
  [-1, 1]) stands in for ``train_data``;
- the noise of the codec's bit estimate comes from a ``torch.Generator``
  seeded from ``seed + 1`` and the step, as the JAX trainer derives its
  keys (``:222``, ``:245``); the numbers differ from ``jax.random``'s;
- checkpoints are the port's safetensors files (``utils/checkpoint.py``),
  where JAX writes orbax trees; the writer appends to
  ``<run_dir>/metrics.jsonl`` and writes PNGs
  (``utils/logging.py:make_writer``) beside JAX's TensorBoard summaries
  (``<run_dir>/tb``, where the package imports).

The trainer runs on the card unless the caller (or the config's
``device``) names a device: with no device and no GPU it raises
(``resolve_device``, as ``OneDCRuntime``). A step and an eval epoch run
under ``utils.numerics.pinned_numerics`` (f32 without TF32, deterministic
cuDNN).

Usage:
  python -m onedc_tpu_torch.train.trainer --config configs/train_stage1.yaml \\
      [key.path=value ...] [--resume]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import load_config
from ..data.crops import MultiResolutionCrop, random_crop
from ..data.datasets import DataLoader, ImageFolderDataset, cycle, \
    make_grain_loader
from ..models.onedc import OneDC, resolve_device
from ..nn.lpips import load_lpips, nhwc_metric
from ..nn.vae import hwio_conv_weights
from ..parallel.distributed import initialize, is_main_process, \
    reduce_mean_across_hosts, world_size
from ..parallel.fsdp import shard_model
from ..parallel.mesh import DATA_AXIS, axis_rank, axis_size, make_mesh, \
    rank_rows
from ..utils.checkpoint import CheckpointManager
from ..utils.logging import AvgDict, get_logger, make_writer
from ..utils.numerics import pinned
from ..utils.preempt import PreemptionGuard
from .losses import RDLoss
from .step import create_train_state, make_train_step, split_frozen

log = get_logger("onedc_tpu_torch.train")


def save_config_snapshot(cfg: Mapping, run_dir) -> None:
    """The resolved config as ``<run_dir>/config.yaml``: lists for tuples,
    ``<TypeName>`` for any value YAML cannot hold (an in-memory state dict
    given as a warm start). Process 0 writes it."""
    import yaml

    if not is_main_process():
        return

    def clean(o):
        if isinstance(o, Mapping):
            return {k: clean(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [clean(v) for v in o]
        if isinstance(o, (str, int, float, bool, type(None))):
            return o
        return f"<{type(o).__name__}>"

    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    with open(run_dir / "config.yaml", "w") as f:
        yaml.safe_dump(clean(dict(cfg)), f, default_flow_style=False)


def load_part_ckpts(model: OneDC, cfg: Mapping, logger) -> OneDC:
    """Warm starts from the reference's checkpoints before training, into
    ``model`` in place (the reference's ``load_part_ckpt``):
    ``codec_ckpt``, the IntraNoAR state dict, every codec tensor required;
    ``unet_ckpt_lora``, the SD1.5 UNet + LoRA state dict, partial allowed,
    the LoRA merged at load; ``codeformer_ckpt``, the Codeformer's state
    dict, every Codeformer tensor required. Each is a torch-layout
    safetensors file or an in-memory ``{name: tensor}``; what they leave
    untouched keeps its initial values. No VQGAN path, as in the JAX
    package (its tokenizer stays at its initial weights)."""
    part = dict(unet_path=cfg.get("unet_ckpt_lora"),
                codec_path=cfg.get("codec_ckpt"),
                codeformer_path=cfg.get("codeformer_ckpt"))
    if not any(part.values()):
        return model
    from ..utils.port_torch import port_onedc_checkpoint

    logger.info("warm-start from reference checkpoints: %s",
                {k: (v if isinstance(v, str) else f"<{type(v).__name__}>")
                 for k, v in part.items() if v})
    required = tuple(sub for sub, key in (("codec", "codec_path"),
                                          ("codeformer", "codeformer_path"))
                     if part[key])
    state = port_onedc_checkpoint(reference=model.state_dict(),
                                  require_complete=required, **part)
    model.load_state_dict(state, strict=True)
    return model


class Trainer:
    def __init__(self, cfg: Mapping, device=None,
                 batches: Optional[Iterable] = None):
        """The model starts from torch's default initialisation under
        ``seed``, then the config's warm starts. ``device``: None takes
        the config's ``device``, and with neither the card."""
        self.cfg = cfg
        if cfg.get("loader", "simple") not in ("simple", "grain"):
            raise ValueError(f"loader: {cfg['loader']!r}: simple or grain")
        if not cfg.get("lpips_weights"):
            # a config error fails before any model build
            if not cfg.get("allow_no_lpips", False):
                raise ValueError(
                    "no lpips_weights configured. The reference stage-1 loss "
                    "is L1 + LPIPS + lambda*bpp; training without LPIPS "
                    "changes the objective. Set lpips_weights: <path> or "
                    "allow_no_lpips: true.")
            log.warning("training WITHOUT the LPIPS term (allow_no_lpips)")
        self.device = resolve_device(device if device is not None
                                     else cfg.get("device"))
        self.seed = int(cfg.get("seed", 0))
        # the loss's VGG: frozen, outside the model, so never in the
        # optimizer or the frozen split; gradients reach x_hat through it
        self.lpips = (load_lpips(cfg["lpips_weights"], avg_pool=True,
                                 device=self.device)
                      if cfg.get("lpips_weights") else None)

        torch.manual_seed(self.seed)
        with torch.device(self.device):
            model = OneDC(**dict(cfg.get("model", {})))
        load_part_ckpts(model, cfg, log)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        # the K2 conv weights laid out HWIO once: valid because the VAE is
        # frozen (the optimizer never writes them)
        hwio_conv_weights(model.vae)
        self.model = model

        # the VQGAN is the frozen distillation target; the Codeformer trains
        default_frozen = (("vae", "vqgan") if model.use_codeformer
                          else ("vae",))
        self.frozen = tuple(cfg.get("frozen", default_frozen))
        if "vae" not in self.frozen:
            raise ValueError("the VAE must stay frozen")
        self.mesh, self.runner, self.replicated = data_parallel(
            model, self.frozen, self.device, bool(cfg.get("fsdp", False)))
        self.state = self._fresh_state(float(cfg.get("lr", 5e-5)))
        self.trainable_names = [n for n, _ in split_frozen(model,
                                                           self.frozen)[0]]

        lmbda = float(cfg.get("lmbda", 1.8))
        sched = cfg.get("lmbda_schedule") or dict(
            start_step=0, end_step=4000, start_value=1e-4, end_value=lmbda)
        self.loss = RDLoss(
            pix_weight=float(cfg.get("pix_weight", 1.0)),
            lpips_weight=float(cfg.get("lpips_weight", 1.0)),
            lmbda=lmbda, lmbda_schedule=dict(sched),
            pix_loss_type=cfg.get("pix_loss_type", "l1"),
            lpips_fn=nhwc_metric(self.lpips) if self.lpips else None)
        self.grad_accum = int(cfg.get("grad_accum", 1))
        # JAX's two accumulation programs are one host loop here: the mode
        # is checked so that a JAX config loads, and changes nothing
        mode = cfg.get("grad_accum_mode", "scan")
        if mode not in ("scan", "unrolled"):
            raise ValueError(f"grad_accum_mode {mode!r}: scan or unrolled")
        self.codeformer_weights = (
            float(cfg.get("codeformer_loss_weight", 1e-3)),
            float(cfg.get("codeformer_mse_weight", 1e-2)))
        self.step_fn = make_train_step(
            self.loss, self.grad_accum,
            remat=bool(cfg.get("gradient_checkpointing", True)),
            codeformer_loss_weight=self.codeformer_weights[0],
            codeformer_mse_weight=self.codeformer_weights[1])

        # data
        self.batch_size = int(cfg.get("batch_size", 8))
        res = int(cfg.get("base_resolution", 512))
        self.crop = MultiResolutionCrop(cfg.get("resolutions", [res]),
                                        cfg.get("batch_scales", None))
        self.train_loader = None
        # how many ranks split each global batch at the loader: the worker
        # loader reads a share per rank, the others the whole on each rank
        self.loader_shares = 1
        if batches is not None:
            self.train_iter = iter(batches)
        elif cfg.get("train_data") and cfg.get("loader") == "grain":
            # worker processes read the images; the stream's position
            # rides the checkpoints (loader_state_*.bin), so a resumed run
            # continues it exactly
            self.loader_shares = world_size()
            if self.batch_size % self.loader_shares:
                raise ValueError(f"loader: grain: batch_size "
                                 f"{self.batch_size} over "
                                 f"{self.loader_shares} ranks")
            self.train_iter = make_grain_loader(
                ImageFolderDataset(cfg["train_data"]),
                self.batch_size // self.loader_shares,
                shuffle=True, seed=self.seed,
                num_workers=int(cfg.get("loader_workers", 8)))
        elif cfg.get("train_data"):
            self.train_loader = DataLoader(
                ImageFolderDataset(cfg["train_data"]), self.batch_size,
                shuffle=True, seed=self.seed)
            self.train_iter = cycle(self.train_loader)
        else:
            self.train_iter = None
        self.eval_loader = (DataLoader(ImageFolderDataset(cfg["eval_data"]),
                                       1)
                            if cfg.get("eval_data") else None)

        run_dir = Path(cfg.get("run_dir", "runs/stage1"))
        self.ckpt = CheckpointManager(run_dir,
                                      int(cfg.get("max_checkpoint", 3)))
        save_config_snapshot(cfg, run_dir)
        self.writer = make_writer(run_dir, cfg.get("wandb_project"))
        self.writer.log_config(cfg)
        self.log_interval = int(cfg.get("log_interval", 200))
        self.save_interval = int(cfg.get("save_interval", 5000))
        self.total_steps = int(cfg.get("total_steps", 400_000))

    def _fresh_state(self, lr: float):
        cfg = self.cfg
        state = create_train_state(
            self.model, lr=lr, warmup_steps=int(cfg.get("warmup_steps", 500)),
            grad_clip=float(cfg.get("grad_clip", 5.0)), frozen=self.frozen,
            optimizer=cfg.get("optimizer", "adamw"))
        return over_ranks(state, self.mesh, self.runner, self.replicated)

    # -- one training step ---------------------------------------------------

    def _prepare_batch(self, batch, step: int) -> Dict[str, torch.Tensor]:
        """The step's resolution and global batch size
        (``MultiResolutionCrop.pick``; the size rounded down to a multiple
        of ``data x grad_accum``, at least one image per rank and
        micro-batch), then one random crop per image from a generator
        seeded by the step. Where the loader reads a share per rank
        (``loader_shares`` > 1), ``batch`` is this rank's share and the
        result its 1/shares of the global batch, cropped by a generator
        seeded by the step and the rank."""
        res, scale = self.crop.pick(step)
        n_data = axis_size(self.mesh) * self.grad_accum
        bs = max(1, int(round(self.batch_size * scale)))
        bs = max(n_data, bs // n_data * n_data)
        shares = self.loader_shares
        rng = np.random.default_rng(
            step if shares == 1 else (step, axis_rank(self.mesh)))
        imgs = np.stack([random_crop(im, res, rng)
                         for im in batch["image"][:bs // shares]])
        return {"image": torch.from_numpy(
            np.ascontiguousarray(imgs, np.float32)).to(self.device)}

    def noise_generator(self, step: int) -> torch.Generator:
        """The generator of the step's bit-estimate noise, seeded from
        ``seed + 1`` and ``step``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.seed + 1) << 32) + step)
        return gen

    @pinned
    def train_one_step(self, step: int) -> Dict[str, float]:
        if self.train_iter is None:
            raise ValueError("no training data: set train_data (an image "
                             "folder) or pass batches")
        image = self._prepare_batch(next(self.train_iter), step)["image"]
        # the global batch's noise, then this rank's rows of both (of the
        # noise alone where the loader gave this rank its rows)
        n = image.shape[0] * self.loader_shares
        noise = self.model.bit_noise(image[:1].expand(n, -1, -1, -1),
                                     self.noise_generator(step))
        rows = rank_rows(n, self.mesh, self.grad_accum)
        if self.loader_shares == 1:
            image = image[rows]
        return self.step_fn(self.state, {"image": image},
                            noise=noise[rows])

    # -- eval epoch ----------------------------------------------------------

    @pinned
    @torch.no_grad()
    def eval_one_epoch(self, step: int, max_images=None) -> Dict[str, float]:
        """The training objective on the eval set: the full RD loss (pixel
        + LPIPS where configured + lambda * bpp, the lambda schedule read
        at ``step``; with the Codeformer its weighted distillation term in
        ``total_loss`` and the unweighted one as ``codeformer_loss``),
        ``bpp_hard_y``, ``mse`` and ``psnr``, averaged over the images; the
        best checkpoint is chosen by its ``total_loss``.
        Each image is cut to its top-left multiple of 64 in each side, as
        the JAX trainer does. The whole eval loader unless
        ``eval_max_images`` (or ``max_images``) caps it; the first image's
        reconstruction and source go to the writer."""
        if self.eval_loader is None:
            return {}
        if max_images is None:
            max_images = self.cfg.get("eval_max_images")  # None = all
        avg = AvgDict()
        for i, batch in enumerate(self.eval_loader):
            img = torch.from_numpy(batch["image"])
            h, w = img.shape[1] // 64 * 64, img.shape[2] // 64 * 64
            img = img[:, :h, :w].contiguous().to(self.device)
            enc_dict, pred = self.model(img)
            total, ld = self.loss(img, pred, enc_dict["bpp"], step=step,
                                  training=True)
            ld["bpp_hard_y"] = enc_dict["bpp_hard_y"]
            if "code_ce_loss" in enc_dict:
                weight, mse_weight = self.codeformer_weights
                cf = (enc_dict["code_ce_loss"]
                      + enc_dict["code_mse_loss"] * mse_weight)
                ld["total_loss"] = total + cf * weight
                ld["codeformer_loss"] = cf
            mse = float(torch.mean((pred - img) ** 2))
            avg.update({k: float(v) for k, v in ld.items()})
            avg.update({"mse": mse,
                        "psnr": -10 * np.log10(max(mse / 4, 1e-12))})
            if i == 0:
                self.writer.log_image("eval/recon", pred[0].cpu().numpy(),
                                      step)
                self.writer.log_image("eval/gt", img[0].cpu().numpy(), step)
            # break after the image, so a capped epoch reads no extra one
            if max_images is not None and i + 1 >= max_images:
                break
        means = reduce_mean_across_hosts(avg.mean())
        self.writer.log_dict(means, step, prefix="eval")
        return means

    # -- checkpoints ---------------------------------------------------------

    def checkpoint_state(self) -> Tuple[Dict[str, torch.Tensor],
                                        Dict[str, str]]:
        """What a checkpoint holds, as live tensors (restore copies into
        them): ``params/<name>`` for every parameter of the model (the
        frozen VAE's too) and the optimizer's state of the trainable ones
        (``adamw/mu/<name>`` and ``adamw/nu/<name>``, or Adafactor's
        ``adafactor/v_row|v_col|v/<name>``); and the step and the
        optimizer's count (``adamw_count`` or ``adafactor_count``) as
        metadata."""
        opt = self.state.optimizer
        tensors = {f"params/{n}": p.data
                   for n, p in self.model.named_parameters()}
        tensors.update(opt.named_state(self.trainable_names))
        return tensors, {"train_step": str(self.state.step),
                         f"{opt.name}_count": str(opt.count)}

    def save_checkpoint(self, step: int, metric: Optional[float] = None):
        """``checkpoint_state`` as the checkpoint of ``step``; its bytes and
        seconds go to the writer (``checkpoint/bytes``, ``/save_s``)."""
        tensors, meta = self.checkpoint_state()
        t0 = time.perf_counter()
        path = self.ckpt.save(tensors, step, metric, meta)
        self._save_loader_state(step)
        if is_main_process():
            nbytes = sum(f.stat().st_size for f in path.iterdir())
            self.writer.log_dict({"bytes": nbytes,
                                  "save_s": time.perf_counter() - t0}, step,
                                 prefix="checkpoint")
        return path

    # -- the worker loader's position (loader: grain) -------------------------

    def _loader_state_path(self, step: int) -> Path:
        return Path(self.ckpt.run_dir) / f"loader_state_{step:06d}.bin"

    def _save_loader_state(self, step: int) -> None:
        """The worker loader's position beside the checkpoint of ``step``,
        on process 0 (each rank's stream is a function of the same
        position), the oldest beyond ``max_checkpoint`` removed; the simple
        loader needs none (``cycle(skip=)`` rebuilds its position from the
        step)."""
        get_state = getattr(self.train_iter, "get_state", None)
        if get_state is None or not is_main_process():
            return
        self._loader_state_path(step).write_bytes(get_state())
        states = sorted(Path(self.ckpt.run_dir).glob("loader_state_*.bin"))
        while len(states) > self.ckpt.max_checkpoints:
            states.pop(0).unlink()

    # -- main loop -----------------------------------------------------------

    def train(self) -> None:
        start = int(self.state.step)
        if start and self.train_loader is not None:
            # resumed: fast-forward the stream, no loads
            self.train_iter = cycle(self.train_loader, skip=start)
        log.info("training from step %d to %d", start, self.total_steps)
        t0 = time.perf_counter()
        with PreemptionGuard() as preempt:
            for step in range(start, self.total_steps):
                metrics = self.train_one_step(step)
                if (step + 1) % self.log_interval == 0:
                    m = dict(metrics)
                    dt = (time.perf_counter() - t0) / self.log_interval
                    m["sec_per_step"] = dt
                    t0 = time.perf_counter()
                    self.writer.log_dict(m, step + 1, prefix="train")
                    log.info("step %d: loss=%.4f bpp=%.4f (%.2fs/step)",
                             step + 1, m["total_loss"], m["bpp"], dt)
                saved = False
                if (step + 1) % self.save_interval == 0:
                    ev = self.eval_one_epoch(step + 1)
                    # the best checkpoint by the full training objective
                    self.save_checkpoint(step + 1, ev.get("total_loss"))
                    saved = True
                if preempt.triggered:
                    # SIGTERM / SIGUSR1: save once and stop, so the run
                    # resumes from this step
                    if not saved:
                        self.save_checkpoint(step + 1)
                    log.info("preempted: checkpointed step %d, stopping",
                             step + 1)
                    break
        self.writer.flush()

    def resume(self, step: Optional[int] = None) -> int:
        """The checkpoint of ``step`` (None: the latest) into the live
        state, bit for bit; then ``override_lr`` (a fresh optimizer at that
        lr, its state and count reset, the step kept) and
        ``override_step``.
        Returns the checkpoint's step; the restore's seconds go to the
        writer (``checkpoint/restore_s``)."""
        tensors, _ = self.checkpoint_state()
        t0 = time.perf_counter()
        meta, restored = self.ckpt.restore(tensors, step)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.writer.log_dict({"restore_s": time.perf_counter() - t0},
                             restored, prefix="checkpoint")
        set_state = getattr(self.train_iter, "set_state", None)
        if set_state is not None:
            path = self._loader_state_path(int(restored))
            if path.exists():
                set_state(path.read_bytes())
                log.info("restored the loader's position at step %d",
                         restored)
            else:
                log.warning("no loader state for step %d: the data stream "
                            "restarts from its beginning", restored)
        self.state.step = int(meta["train_step"])
        opt = self.state.optimizer
        opt.count = int(meta[f"{opt.name}_count"])
        if self.cfg.get("override_lr") is not None:
            new_lr = float(self.cfg["override_lr"])
            cur_step = self.state.step
            self.state = self._fresh_state(new_lr)
            self.state.step = cur_step
            log.info("override_lr: fresh optimizer at lr=%g", new_lr)
        if self.cfg.get("override_step") is not None:
            self.state.step = int(self.cfg["override_step"])
            log.info("override_step: step rewritten to %d", self.state.step)
        log.info("resumed from step %d", restored)
        return restored


def main(argv=None) -> Trainer:
    """``--config FILE [key.path=value ...] [--resume]``: build the trainer
    (on the card unless ``device=`` names another), resume from the run
    directory's latest checkpoint if asked, train to ``total_steps``.
    Returns the trainer."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default=None)
    parser.add_argument("--resume", action="store_true")
    args, overrides = parser.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    initialize()  # torchrun's group, if any (``multihost`` asks the same)
    trainer = Trainer(cfg)
    if args.resume:
        trainer.resume()
    trainer.train()
    return trainer


def data_parallel(model: torch.nn.Module, frozen, device: torch.device,
                  fsdp: bool, forward_methods=(), ddp: bool = True):
    """(mesh, runner, replicated) of a model trained over the process
    group: no mesh in one process without ``fsdp``; with ``fsdp``, the
    model sharded in place (``parallel/fsdp.py:shard_model``) and the
    parameters it leaves replicated; else with more than one rank the
    model's DDP wrapper as the runner (``find_unused_parameters``: the
    frozen encoders run without autograd), or with ``ddp`` false the model
    itself (the caller all-reduces its gradients)."""
    if not fsdp and world_size() == 1:
        return None, model, []
    mesh = make_mesh(device.type)
    if fsdp:
        return mesh, model, shard_model(model, mesh, frozen,
                                        forward_methods)
    if not ddp:
        return mesh, model, []
    from torch.nn.parallel import DistributedDataParallel

    ids = [torch.cuda.current_device()] if device.type == "cuda" else None
    return mesh, DistributedDataParallel(
        model, device_ids=ids, process_group=mesh[DATA_AXIS].get_group(),
        find_unused_parameters=True), []


def over_ranks(state, mesh, runner, replicated):
    """``state`` with its data-parallel fields set (``TrainState``)."""
    if mesh is not None:
        state.runner, state.replicated = runner, replicated
        state.group = mesh[DATA_AXIS].get_group()
    return state


if __name__ == "__main__":
    main()
