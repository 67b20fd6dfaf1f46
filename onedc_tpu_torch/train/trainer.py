"""Stage-I trainer: rate-distortion training of the codec and the one-step
generator.

JAX counterpart: ``onedc_tpu/train/trainer.py:93-246`` (``Trainer``,
``_prepare_batch``, ``train_one_step``), read from the same config keys:
``lr``, ``warmup_steps``, ``grad_clip``, ``frozen``, ``lmbda``,
``lmbda_schedule``, ``pix_weight``, ``lpips_weight``, ``pix_loss_type``,
``lpips_weights`` / ``allow_no_lpips``, ``batch_size``, ``resolutions``,
``batch_scales``, ``seed``, ``optimizer``, ``fsdp``, ``grad_accum`` and
``model``.

Differences, by design or not yet ported:
- batches come from an iterator of numpy ``{"image": (B, H, W, 3)}`` in
  [-1, 1] passed to the trainer; the image-folder datasets, checkpoints,
  eval, writers and preemption come in a later slice;
- one device, no FSDP, AdamW only, ``grad_accum`` 1, no rematerialisation
  (``gradient_checkpointing`` changes memory, not the result);
- the noise of the codec's bit estimate comes from a ``torch.Generator``
  seeded from ``seed + 1`` and the step, as the JAX trainer derives its
  keys (``:222``, ``:245``); the numbers differ from ``jax.random``'s.

The trainer runs on the card unless the caller names a device: with no
device and no GPU it raises (``resolve_device``, as ``OneDCRuntime``).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ..data.crops import MultiResolutionCrop, random_crop
from ..models.onedc import OneDC, resolve_device
from ..nn.vae import hwio_conv_weights
from .losses import RDLoss
from .step import create_train_state, make_train_step

log = logging.getLogger("onedc_tpu_torch.train")


class Trainer:
    def __init__(self, cfg: Mapping, device=None,
                 batches: Optional[Iterable] = None):
        """The model starts from torch's default initialisation under
        ``seed``. ``batches``: an iterable of numpy batches (see the module
        docstring)."""
        self.cfg = cfg
        if cfg.get("lpips_weights"):
            raise NotImplementedError("LPIPS is not ported yet: train with "
                                      "allow_no_lpips: true")
        if not cfg.get("allow_no_lpips", False):
            raise ValueError(
                "no lpips_weights configured. The reference stage-1 loss is "
                "L1 + LPIPS + lambda*bpp; training without LPIPS changes the "
                "objective. Set allow_no_lpips: true to train without it.")
        log.warning("training WITHOUT the LPIPS term (allow_no_lpips)")
        if cfg.get("fsdp", False):
            raise NotImplementedError("fsdp: multi-GPU training is not "
                                      "ported yet")
        self.device = resolve_device(device)
        self.seed = int(cfg.get("seed", 0))

        torch.manual_seed(self.seed)
        with torch.device(self.device):
            model = OneDC(**dict(cfg.get("model", {})))
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        # the K2 conv weights laid out HWIO once: valid because the VAE is
        # frozen (the optimizer never writes them)
        hwio_conv_weights(model.vae)
        self.model = model

        self.frozen = tuple(cfg.get("frozen", ("vae",)))
        if "vae" not in self.frozen:
            raise ValueError("the VAE must stay frozen")
        self.state = create_train_state(
            model, lr=float(cfg.get("lr", 5e-5)),
            warmup_steps=int(cfg.get("warmup_steps", 500)),
            grad_clip=float(cfg.get("grad_clip", 5.0)),
            frozen=self.frozen, optimizer=cfg.get("optimizer", "adamw"))

        lmbda = float(cfg.get("lmbda", 1.8))
        sched = cfg.get("lmbda_schedule") or dict(
            start_step=0, end_step=4000, start_value=1e-4, end_value=lmbda)
        self.loss = RDLoss(
            pix_weight=float(cfg.get("pix_weight", 1.0)),
            lpips_weight=float(cfg.get("lpips_weight", 1.0)),
            lmbda=lmbda, lmbda_schedule=dict(sched),
            pix_loss_type=cfg.get("pix_loss_type", "l1"))
        self.step_fn = make_train_step(self.loss,
                                       int(cfg.get("grad_accum", 1)))

        self.batch_size = int(cfg.get("batch_size", 8))
        res = int(cfg.get("base_resolution", 512))
        self.crop = MultiResolutionCrop(cfg.get("resolutions", [res]),
                                        cfg.get("batch_scales", None))
        self.train_iter = iter(batches) if batches is not None else None

    def _prepare_batch(self, batch, step: int) -> Dict[str, torch.Tensor]:
        """The step's resolution and batch size (``MultiResolutionCrop.
        pick``), then one random crop per image from a generator seeded by
        the step."""
        res, scale = self.crop.pick(step)
        bs = max(1, int(round(self.batch_size * scale)))
        rng = np.random.default_rng(step)
        imgs = np.stack([random_crop(im, res, rng)
                         for im in batch["image"][:bs]])
        return {"image": torch.from_numpy(
            np.ascontiguousarray(imgs, np.float32)).to(self.device)}

    def noise_generator(self, step: int) -> torch.Generator:
        """The generator of the step's bit-estimate noise, seeded from
        ``seed + 1`` and ``step``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.seed + 1) << 32) + step)
        return gen

    def train_one_step(self, step: int) -> Dict[str, float]:
        if self.train_iter is None:
            raise ValueError("no batches: pass an iterable of numpy batches "
                             "(the image-folder datasets are not ported "
                             "yet)")
        batch = self._prepare_batch(next(self.train_iter), step)
        return self.step_fn(self.state, batch,
                            generator=self.noise_generator(step))
