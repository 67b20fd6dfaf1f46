"""Stage-II trainer: the DMD2 fine-tune of the one-step generator.

JAX counterpart: ``onedc_tpu/train/trainer_stage2.py``
(``create_stage2_states`` :40, here ``train/step.py``;
``make_generator_step`` :65, ``make_guidance_step`` :136,
``Stage2Trainer`` :182 with ``round_batch`` :298, ``eval_one_epoch`` :317,
``train`` :359, ``resume`` :438; ``main`` :453), read from the same config
keys: those of ``configs/train_stage2.yaml`` and ``optimizer``,
``gradient_checkpointing``, ``grad_accum``, ``stage1_ckpt``,
``codec_ckpt`` / ``unet_ckpt_lora`` / ``codeformer_ckpt``,
``guidance_ckpt``, ``allow_no_lpips``, ``eval_data``, ``eval_max_images``,
``monitor_key``, ``max_checkpoint``; and the port's own ``device`` and
``text_encoder_config`` (CLIP widths over ``SD15_TEXT_CONFIG``, for small
runs). Two optimizers, two turns:

- the GENERATOR turn, every ``dfake_gen_update_ratio``-th step: codec and
  VAE frozen, loss = ``dm_loss_weight`` * DM + ``gen_cls_loss_weight`` *
  gen-cls + ``pix_loss_weight`` * (L1 + LPIPS) on the one-step UNet; the
  other steps make the critic's latents without a generator update
  (``OneDC.training_latents``);
- the GUIDANCE turn, every step: the fake UNet's epsilon MSE +
  ``guidance_cls_loss_weight`` * the diffusion-GAN loss, ``real_unet``
  frozen, on the generator's latents detached.

JAX differentiates only the state being updated. Here each turn takes the
gradients of its own trainable parameters alone: the generator turn's
gen-cls logit passes through the fake UNet's down path and the head, so
the critic's trainable parameters stop requiring gradients for that turn,
and the guidance turn sees detached latents; neither fills the other's
``.grad``. The frozen parts (``vae``, ``codec``, ``real_unet``) hold no
autograd record at all. (``torch.autograd.backward(..., inputs=...)``
would name the parameters that a module holds; under FSDP the graph holds
the gathered copies that FSDP swaps in for each forward, so those inputs
would never receive a gradient.)

Over several processes, as the stage-I trainer (``train/trainer.py``):
``fsdp: true`` shards both states (JAX :228-238: the generator without
``vae`` / ``codec``, the critic without ``real_unet``), else more than
one rank all-reduces each turn's gradients (the turns enter the critic
through its methods, which DDP's wrapper would not see). Every rank
draws the global batch, the codec's noise and both turns' t and noise
draws for all of it, and keeps its rows.

``gradient_checkpointing`` (default true, as JAX)
rematerialises the OneDC forward of the generator turn and the guidance
forward (``utils/remat.py``); ``grad_accum`` runs micro-batches of
consecutive rows into one update, as stage I.

Differences, by design or not yet ported:
- the random numbers come from ``torch.Generator``s, two per step (the
  generator turn's codec noise and DM / GAN draws, the guidance turn's
  draws) seeded from ``seed + 2`` and the step, as JAX folds the step into
  its key; a resumed run continues the same numbers, which differ from
  ``jax.random``'s;
- ``stage1_ckpt`` takes the JAX package's parameter file ("/"-joined keys)
  or a checkpoint directory of the port's stage-I trainer;
- checkpoints are the port's safetensors (``gen/...`` and ``guid/...``),
  the writer ``utils/logging.py:RunWriter``.

Usage:
  python -m onedc_tpu_torch.train.trainer_stage2 \\
      --config configs/train_stage2.yaml [key.path=value ...] [--resume]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from ..config import load_config
from ..data.datasets import DataLoader, ImageFolderDataset, cycle
from ..models.dmd import SDGuidance
from ..models.onedc import OneDC, resolve_device
from ..nn.lpips import load_lpips, nhwc_metric
from ..nn.text_encoder import TextEncoder
from ..nn.vae import hwio_conv_weights
from ..parallel.distributed import initialize, is_main_process, \
    reduce_mean_across_hosts
from ..parallel.fsdp import local
from ..parallel.mesh import axis_size, rank_rows
from ..utils.checkpoint import STATE_FILE, CheckpointManager
from ..utils.logging import AvgDict, get_logger, make_writer
from ..utils.numerics import pinned
from ..utils.preempt import PreemptionGuard
from ..utils.remat import rematerialized
from .losses import RDLoss
from .step import TrainState, create_stage2_states, split_frozen
from .trainer import data_parallel, load_part_ckpts, over_ranks, \
    save_config_snapshot

log = get_logger("onedc_tpu_torch.train2")

Metrics = Dict[str, float]


def _rows(draws: Mapping[str, torch.Tensor], rows: slice):
    return {k: v[rows] for k, v in draws.items()}


def _backward_mean(loss_fn: Callable[[slice], Tuple[torch.Tensor, Dict]],
                   state: TrainState, batch: int, grad_accum: int,
                   held: Sequence[torch.nn.Parameter] = ()
                   ) -> Dict[str, torch.Tensor]:
    """The accumulation loop of both turns: ``loss_fn(rows)`` ->
    (loss, metrics) per micro-batch of consecutive rows, the gradients of
    ``state``'s trainable parameters summed into their ``.grad`` (``held``,
    the other turn's trainable parameters that the loss reaches, require no
    gradient meanwhile), reduced over the ranks and scaled by f32(1/N),
    the metrics averaged alike; then one update."""
    if batch % grad_accum:
        raise ValueError(f"batch {batch} not divisible by grad_accum "
                         f"{grad_accum}")
    params = state.optimizer.params
    for p in params:
        p.grad = None
    for p in held:
        p.requires_grad_(False)
    micro = batch // grad_accum
    sums: Dict[str, torch.Tensor] = {}
    for i in range(grad_accum):
        loss, metrics = loss_fn(slice(i * micro, (i + 1) * micro))
        loss.backward()
        for key, value in metrics.items():
            value = value.detach()
            sums[key] = sums[key] + value if key in sums else value
        del loss, metrics
    for p in held:
        p.requires_grad_(True)
    state.sync_gradients()
    if grad_accum > 1:
        inv = float(np.float32(1.0 / grad_accum))
        torch._foreach_mul_([local(p.grad) for p in params
                             if p.grad is not None], inv)
        sums = {k: v * inv for k, v in sums.items()}
    sums = state.mean_over_ranks(sums)
    state.optimizer.step()
    state.step += 1
    return sums


def make_generator_step(rd_loss: Optional[RDLoss] = None,
                        dm_weight: float = 1.0,
                        gen_cls_weight: float = 1e-3,
                        pix_weight: float = 0.625,
                        remat: bool = False,
                        grad_accum: int = 1) -> Callable:
    """Returns step(gen_state, guidance, batch, text_emb, uncond_emb,
    noise=None, draws=None, generator=None) -> (metrics, aux). The codec's
    noise (``OneDC.bit_noise``) and the guidance's draws
    (``SDGuidance.generator_draws``) are the whole batch's, drawn from
    ``generator`` in that order unless given. Metrics (python floats):
    ``gen_total``, ``loss_dm``, ``gen_cls_loss``, ``pix``, ``bpp`` (the
    hard y rate); aux: ``fake_latents`` (x0) and ``real_latents`` (the VAE
    latents), detached, the whole batch, for the guidance turn."""
    if rd_loss is None:
        rd_loss = RDLoss(lmbda=0.0)  # codec frozen: no rate term

    def step(gen_state: TrainState, guidance: SDGuidance,
             batch: Dict[str, torch.Tensor], text_emb, uncond_emb,
             noise: Optional[torch.Tensor] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[Metrics, Dict[str, torch.Tensor]]:
        model = gen_state.model
        image = batch["image"]
        b, h, w, _ = image.shape
        if noise is None:
            noise = model.bit_noise(image, generator)
        if draws is None:
            draws = guidance.generator_draws(
                image.new_empty((b, model.vae_ch, h // 8, w // 8)),
                generator)
        fake, real = [], []

        def loss_fn(rows: slice):
            img = image[rows]
            enc_dict, pred = model(img, training=True, noise=noise[rows],
                                   remat=remat)
            latents = enc_dict["x_latent_recon"]
            g = guidance.generator_forward(latents, text_emb[rows],
                                           uncond_emb[rows],
                                           draws=_rows(draws, rows))
            pix_total, pix_dict = rd_loss(img, pred, enc_dict["bpp"],
                                          training=True)
            zero = torch.zeros((), device=img.device)
            loss_dm = g.get("loss_dm", zero)
            gen_cls = g.get("gen_cls_loss", zero)
            loss = (dm_weight * loss_dm + gen_cls_weight * gen_cls
                    + pix_weight * pix_total)
            fake.append(latents.detach())
            real.append(enc_dict["x_latent"].detach())
            return loss, {"gen_total": loss, "loss_dm": loss_dm,
                          "gen_cls_loss": gen_cls, "pix": pix_dict["pix"],
                          "bpp": enc_dict["bpp_hard_y"]}

        critic = [p for p in guidance.parameters() if p.requires_grad]
        sums = _backward_mean(loss_fn, gen_state, b, grad_accum, critic)
        aux = {"fake_latents": torch.cat(fake),
               "real_latents": torch.cat(real)}
        return {k: float(v) for k, v in sums.items()}, aux

    return step


def make_guidance_step(guidance_cls_weight: float = 1e-2,
                       remat: bool = False,
                       grad_accum: int = 1) -> Callable:
    """Returns step(guid_state, fake_latents, real_latents, text_emb,
    uncond_emb, draws=None, generator=None) -> metrics: the critic's loss
    ``loss_fake_mean + guidance_cls_weight * guidance_cls_loss`` (the real
    latents scored under the same text), one update of the fake UNet and
    the head. Metrics: ``guid_total`` (the epsilon MSE) and every scalar
    of ``SDGuidance.guidance_forward``."""

    def step(guid_state: TrainState, fake_latents, real_latents, text_emb,
             uncond_emb, draws: Optional[Dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None) -> Metrics:
        guidance = guid_state.model
        if draws is None:
            draws = guidance.guidance_draws(fake_latents, real_latents,
                                            generator)

        def loss_fn(rows: slice):
            args = (fake_latents[rows], real_latents[rows], text_emb[rows],
                    uncond_emb[rows], text_emb[rows], _rows(draws, rows))
            out = (rematerialized(guidance.guidance_forward, *args)
                   if remat else guidance.guidance_forward(*args))
            loss = out["loss_fake_mean"] + guidance_cls_weight * out.get(
                "guidance_cls_loss", torch.zeros((), device=text_emb.device))
            return loss, {"guid_total": out["loss_fake_mean"], **out}

        sums = _backward_mean(loss_fn, guid_state, fake_latents.shape[0],
                              grad_accum)
        return {k: float(v) for k, v in sums.items()}

    return step


def load_stage1(model: OneDC, path) -> None:
    """``stage1_ckpt`` into ``model``, strictly: the JAX package's
    parameter file ("/"-joined keys of the OneDC tree) or a checkpoint
    directory of the port's stage-I trainer (its ``params/<name>``)."""
    path = Path(path)
    if path.is_dir():
        from ..utils.safetensors import load_safetensors
        saved = load_safetensors(path / STATE_FILE)
        state = {k[len("params/"):]: v for k, v in saved.items()
                 if k.startswith("params/")}
    else:
        from ..utils.convert import state_dict_from_safetensors
        state = state_dict_from_safetensors(path)
    model.load_state_dict(state, strict=True)


class Stage2Trainer:
    def __init__(self, cfg: Mapping, device=None,
                 batches: Optional[Iterable] = None):
        """The OneDC generator and the SDGuidance start from torch's default
        initialisation under ``seed``, then ``stage1_ckpt``, the
        reference warm starts (``codec_ckpt`` / ``unet_ckpt_lora``) and
        ``guidance_ckpt``. ``device``: None takes the config's ``device``,
        and with neither the card. ``batches`` (an iterable of
        ``{"image": (B, H, W, 3) numpy in [-1, 1], "caption": [str]}``)
        stands in for ``train_data``."""
        self.cfg = cfg
        if not cfg.get("lpips_weights"):
            if not cfg.get("allow_no_lpips", False):
                raise ValueError(
                    "no lpips_weights configured. The stage-2 pixel loss "
                    "is L1 + LPIPS; set lpips_weights: <path> or "
                    "allow_no_lpips: true.")
            log.warning("stage-2 training WITHOUT the LPIPS pixel term "
                        "(allow_no_lpips)")
        self.device = resolve_device(device if device is not None
                                     else cfg.get("device"))
        self.seed = int(cfg.get("seed", 0))
        self.lpips = (load_lpips(cfg["lpips_weights"], avg_pool=True,
                                 device=self.device)
                      if cfg.get("lpips_weights") else None)

        torch.manual_seed(self.seed)
        with torch.device(self.device):
            onedc = OneDC(**dict(cfg.get("model", {})))
            guidance = SDGuidance(**dict(cfg.get("guidance", {})))
        if cfg.get("stage1_ckpt"):
            load_stage1(onedc, cfg["stage1_ckpt"])
        load_part_ckpts(onedc, cfg, log)
        if cfg.get("guidance_ckpt"):
            from ..utils.port_torch import port_guidance_checkpoint
            log.info("warm-start guidance from %s", cfg["guidance_ckpt"])
            guidance.load_state_dict(port_guidance_checkpoint(
                cfg["guidance_ckpt"], guidance.state_dict()), strict=True)
        if self.device.type == "cuda":
            onedc = onedc.to(memory_format=torch.channels_last)
            guidance = guidance.to(memory_format=torch.channels_last)
        hwio_conv_weights(onedc.vae)  # the VAE is frozen
        self.onedc, self.guidance = onedc, guidance
        # sharded before the optimizers take the parameters (FSDP swaps
        # them for sharded ones); the frozen sets are create_stage2_states'
        fsdp = bool(cfg.get("fsdp", False))
        gen_dp = data_parallel(onedc, ("vae", "codec"), self.device, fsdp,
                               ("training_latents",), ddp=False)
        guid_dp = data_parallel(guidance, ("real_unet",), self.device, fsdp,
                                ("generator_forward", "guidance_forward"),
                                ddp=False)
        self.mesh = gen_dp[0]
        self.gen_state, self.guid_state = create_stage2_states(
            onedc, guidance, gen_lr=float(cfg.get("gen_lr", 1e-6)),
            guid_lr=float(cfg.get("guid_lr", 1e-6)),
            optimizer=cfg.get("optimizer", "adamw"))
        for state, (mesh, _, replicated) in ((self.gen_state, gen_dp),
                                             (self.guid_state, guid_dp)):
            if mesh is not None and not fsdp:
                # no DDP wrapper: every trainable gradient is all-reduced
                replicated = [p for p in state.optimizer.params]
            over_ranks(state, mesh, state.model, replicated)
        self.names = {tag: [n for n, _ in split_frozen(st.model,
                                                        st.frozen)[0]]
                      for tag, st in (("gen", self.gen_state),
                                      ("guid", self.guid_state))}

        self.rd_loss = RDLoss(
            pix_weight=float(cfg.get("pix_weight", 1.0)),
            lpips_weight=float(cfg.get("lpips_weight", 1.0)), lmbda=0.0,
            lpips_fn=nhwc_metric(self.lpips) if self.lpips else None)
        remat = bool(cfg.get("gradient_checkpointing", True))
        self.grad_accum = int(cfg.get("grad_accum", 1))
        self.gen_step = make_generator_step(
            self.rd_loss, dm_weight=float(cfg.get("dm_loss_weight", 1.0)),
            gen_cls_weight=float(cfg.get("gen_cls_loss_weight", 1e-3)),
            pix_weight=float(cfg.get("pix_loss_weight", 0.625)),
            remat=remat, grad_accum=self.grad_accum)
        self.guid_step = make_guidance_step(
            float(cfg.get("guidance_cls_loss_weight", 1e-2)), remat=remat,
            grad_accum=self.grad_accum)

        self.text = TextEncoder(cfg.get("text_encoder_path"),
                                seed=self.seed, device=self.device,
                                config=cfg.get("text_encoder_config"))
        self.update_ratio = int(cfg.get("dfake_gen_update_ratio", 10))
        self.batch_size = int(cfg.get("batch_size", 4))
        self.train_loader = None
        if batches is not None:
            self.train_iter = iter(batches)
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
        self.step = 0  # the steps done: where train() starts
        run_dir = Path(cfg.get("run_dir", "runs/stage2"))
        self.ckpt = CheckpointManager(run_dir,
                                      int(cfg.get("max_checkpoint", 3)))
        save_config_snapshot(cfg, run_dir)
        self.writer = make_writer(run_dir, cfg.get("wandb_project"))
        self.writer.log_config(cfg)
        self.total_steps = int(cfg.get("total_steps", 1_000_000))
        self.log_interval = int(cfg.get("log_interval", 200))
        self.save_interval = int(cfg.get("save_interval", 5000))
        self._uncond = None

    @staticmethod
    def round_batch(imgs_np, captions, n_data: int):
        """The batch length made a multiple of ``n_data``: rounded down
        where possible, rows repeated up to ``n_data`` otherwise."""
        if len(imgs_np) >= n_data:
            bs = (len(imgs_np) // n_data) * n_data
            return imgs_np[:bs], list(captions)[:bs]
        reps = -(-n_data // len(imgs_np))
        return (np.tile(imgs_np, (reps, 1, 1, 1))[:n_data],
                (list(captions) * reps)[:n_data])

    def step_generators(self, step: int) -> Tuple[torch.Generator,
                                                  torch.Generator]:
        """The generator turn's and the guidance turn's generators of
        ``step``, seeded from ``seed + 2`` and the step."""
        out = []
        for turn in range(2):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(((self.seed + 2) << 32) + 2 * step + turn)
            out.append(gen)
        return out[0], out[1]

    def embed(self, captions) -> Tuple[torch.Tensor, torch.Tensor]:
        """(text, unconditional) embeddings of a batch's captions."""
        if self._uncond is None:
            self._uncond = self.text.uncond_embedding(1)
        text = self.text.encode(self.text.tokenize(list(captions)))
        return text, self._uncond.expand(len(captions), -1, -1)

    @pinned
    def train_one_step(self, step: int) -> Metrics:
        """One step: the generator turn when ``step`` is a multiple of
        ``dfake_gen_update_ratio``, else the latents alone; then the
        guidance turn. Returns both turns' metrics."""
        if self.train_iter is None:
            raise ValueError("no training data: set train_data (an image "
                             "folder) or pass batches")
        batch = next(self.train_iter)
        imgs, captions = self.round_batch(
            np.asarray(batch["image"]), batch["caption"],
            axis_size(self.mesh) * self.grad_accum)
        image = torch.from_numpy(np.ascontiguousarray(
            imgs, np.float32)).to(self.device)
        text_emb, uncond = self.embed(captions)
        g_gen, g_guid = self.step_generators(step)
        # the global batch's draws, then this rank's rows of everything
        b, h, w, _ = image.shape
        rows = rank_rows(b, self.mesh, self.grad_accum)
        noise = self.onedc.bit_noise(image, g_gen)
        if step % self.update_ratio == 0:
            draws = self.guidance.generator_draws(
                image.new_empty((b, self.onedc.vae_ch, h // 8, w // 8)),
                g_gen)
            gmet, aux = self.gen_step(
                self.gen_state, self.guidance, {"image": image[rows]},
                text_emb[rows], uncond[rows], noise=noise[rows],
                draws=_rows(draws, rows))
        else:
            real, fake = self.onedc.training_latents(image[rows],
                                                     noise[rows])
            aux = {"fake_latents": fake, "real_latents": real}
            gmet = {}
        fake, real = aux["fake_latents"], aux["real_latents"]
        draws = self.guidance.guidance_draws(
            fake.new_empty((b,) + fake.shape[1:]),
            real.new_empty((b,) + real.shape[1:]), g_guid)
        qmet = self.guid_step(self.guid_state, fake, real, text_emb[rows],
                              uncond[rows], draws=_rows(draws, rows))
        return {**gmet, **qmet}

    @pinned
    @torch.no_grad()
    def eval_one_epoch(self, step: int, max_images=None) -> Metrics:
        """The generator's pixel loss on the eval set (the JAX trainer's:
        the inference forward, ``RDLoss`` with lambda 0, the means over the
        images; the DM terms, which need a guidance forward, are left out
        as there). Each image is cut to its top-left multiple of 64 in each
        side; the first recon and source go to the writer."""
        if self.eval_loader is None:
            return {}
        if max_images is None:
            max_images = self.cfg.get("eval_max_images")
        avg = AvgDict()
        for i, batch in enumerate(self.eval_loader):
            img = torch.from_numpy(batch["image"])
            h, w = img.shape[1] // 64 * 64, img.shape[2] // 64 * 64
            img = img[:, :h, :w].contiguous().to(self.device)
            enc_dict, pred = self.onedc(img)
            _, ld = self.rd_loss(img, pred, enc_dict["bpp"], training=False)
            avg.update({k: float(v) for k, v in ld.items()})
            if i == 0:
                self.writer.log_image("eval/recon", pred[0].cpu().numpy(),
                                      step)
                self.writer.log_image("eval/gt", img[0].cpu().numpy(), step)
            if max_images is not None and i + 1 >= max_images:
                break
        means = reduce_mean_across_hosts(avg.mean())
        self.writer.log_dict(means, step, prefix="eval2")
        log.info("eval step %d: %s", step,
                 {k: round(v, 5) for k, v in means.items()})
        return means

    # -- checkpoints ---------------------------------------------------------

    def checkpoint_state(self) -> Tuple[Dict[str, torch.Tensor],
                                        Dict[str, str]]:
        """``gen/params/<name>`` and ``guid/params/<name>`` for every
        parameter of the two modules (the frozen ones too), each
        optimizer's state under ``gen/`` and ``guid/``; the step and both
        optimizers' counts as metadata."""
        tensors: Dict[str, torch.Tensor] = {}
        meta = {"train_step": str(self.step)}
        for tag, state in (("gen", self.gen_state), ("guid", self.guid_state)):
            tensors.update({f"{tag}/params/{n}": p.data
                            for n, p in state.model.named_parameters()})
            opt = state.optimizer
            tensors.update({f"{tag}/{k}": v for k, v in
                            opt.named_state(self.names[tag]).items()})
            meta[f"{tag}_step"] = str(state.step)
            meta[f"{tag}_{opt.name}_count"] = str(opt.count)
        return tensors, meta

    def save_checkpoint(self, step: int, metric: Optional[float] = None):
        """``checkpoint_state`` as the checkpoint of ``step``; bytes and
        seconds to the writer (``checkpoint/bytes``, ``/save_s``)."""
        tensors, meta = self.checkpoint_state()
        t0 = time.perf_counter()
        path = self.ckpt.save(tensors, step, metric, meta)
        if is_main_process():
            nbytes = sum(f.stat().st_size for f in path.iterdir())
            self.writer.log_dict({"bytes": nbytes,
                                  "save_s": time.perf_counter() - t0}, step,
                                 prefix="checkpoint")
        return path

    def train(self) -> None:
        start = self.step
        if start and self.train_loader is not None:
            # resumed: fast-forward the stream, no loads
            self.train_iter = cycle(self.train_loader, skip=start)
        log.info("stage-2 training from step %d to %d", start,
                 self.total_steps)
        t0 = time.perf_counter()
        with PreemptionGuard() as preempt:
            for step in range(start, self.total_steps):
                metrics = self.train_one_step(step)
                self.step = step + 1
                if (step + 1) % self.log_interval == 0:
                    m = dict(metrics)
                    m["sec_per_step"] = ((time.perf_counter() - t0)
                                         / self.log_interval)
                    t0 = time.perf_counter()
                    self.writer.log_dict(m, step + 1, prefix="train2")
                    log.info("step %d: %s", step + 1,
                             {k: round(v, 5) for k, v in m.items()})
                saved = False
                if (step + 1) % self.save_interval == 0:
                    ev = self.eval_one_epoch(step + 1)
                    metric = None
                    if ev:
                        key = self.cfg.get("monitor_key", "total_loss")
                        if key not in ev:
                            raise KeyError(
                                f"monitor_key={key!r} not among eval "
                                f"metrics {sorted(ev)}")
                        metric = ev[key]
                    self.save_checkpoint(step + 1, metric)
                    saved = True
                if preempt.triggered:
                    if not saved:
                        self.save_checkpoint(step + 1)
                    log.info("preempted: checkpointed step %d, stopping",
                             step + 1)
                    break
        self.writer.flush()

    def resume(self, step: Optional[int] = None) -> int:
        """Both states from the checkpoint of ``step`` (None: the latest),
        bit for bit; training, the data stream and the per-step
        generators continue from that step. Returns it; the restore's
        seconds go to the writer (``checkpoint/restore_s``)."""
        tensors, _ = self.checkpoint_state()
        t0 = time.perf_counter()
        meta, restored = self.ckpt.restore(tensors, step)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.writer.log_dict({"restore_s": time.perf_counter() - t0},
                             restored, prefix="checkpoint")
        for tag, state in (("gen", self.gen_state), ("guid", self.guid_state)):
            state.step = int(meta[f"{tag}_step"])
            opt = state.optimizer
            opt.count = int(meta[f"{tag}_{opt.name}_count"])
        self.step = int(meta["train_step"])
        log.info("restored stage-2 checkpoint at step %d", restored)
        return restored


def main(argv=None) -> Stage2Trainer:
    """``--config FILE [key.path=value ...] [--resume]``: build the
    stage-II trainer (on the card unless ``device=`` names another),
    resume from the run directory's latest checkpoint if asked, train to
    ``total_steps``. Returns the trainer."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default=None)
    parser.add_argument("--resume", action="store_true")
    args, overrides = parser.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    initialize()  # torchrun's group, if any (``multihost`` asks the same)
    trainer = Stage2Trainer(cfg)
    if args.resume:
        trainer.resume()
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
