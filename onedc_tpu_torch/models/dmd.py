"""DMD2 guidance for stage-II training: the frozen ``real_unet`` and the
trainable ``fake_unet`` (both plain SD1.5 text-conditioned UNets) with the
diffusion-GAN head on the fake UNet's mid-block feature.

JAX counterpart: ``onedc_tpu/models/dmd.py`` (``add_noise`` :34,
``ClsHead`` :41, ``SDGuidance`` :68: ``_predict_noise`` :94,
``compute_cls_logits`` :107, ``distribution_matching_loss`` :121,
``loss_fake`` :153, ``generator_forward`` :168, ``guidance_forward``
:184), with the same losses:

- distribution matching: grad = (p_real - p_fake) / mean|p_real| per image,
  through ``nan_to_num``, applied as the detached-target MSE
  ``0.5 * mean((lat - stop(lat - grad))²)``, so d loss / d latents =
  grad / N; the timesteps lie in [min_step, max_step] ([20, 640] at the
  stage-II config); CFG runs as one 2B forward when the scale is above 1;
- the critic's epsilon MSE on detached latents;
- the diffusion-GAN logit: the latents noised at t in [0,
  ``diffusion_gan_max_timestep``), the fake UNet's mid-block feature, the
  conv head, softplus losses.

Latents are NCHW, as everywhere in the port. The random draws (each
loss's timesteps and Gaussian noise) come from an explicit
``torch.Generator`` through ``generator_draws`` / ``guidance_draws``, made
before any rematerialised region; each forward also takes the draws
directly, so a test hands over ``jax.random``'s (a documented difference:
the numbers of a seeded run differ from the JAX package's, as the codec's
noise does in stage I). The two UNets of the distribution-matching loss
run without an autograd record: their inputs are detached and their
outputs feed a detached target, so no gradient reaches them (JAX's
``stop_gradient``), and no turn differentiates them there.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import Conv2d, GroupNorm
from ..nn.diffusion import get_x0_from_noise, make_alphas_cumprod
from ..nn.unet_sd import SD15UNet

Draws = Dict[str, torch.Tensor]


def add_noise(latents, noise, timesteps, alphas_cumprod):
    """DDPM q(x_t | x_0) (diffusers ``scheduler.add_noise``), alpha_bar
    read from the f32 table."""
    table = torch.as_tensor(np.asarray(alphas_cumprod, np.float32),
                            device=latents.device)
    abar = table[timesteps.long()].reshape(-1, 1, 1, 1).to(latents.dtype)
    return torch.sqrt(abar) * latents + torch.sqrt(1.0 - abar) * noise


class ClsHead(nn.Module):
    """Mid-block feature (C at /64 of the image: 8x8 at 512 px) -> one
    realism logit (B, 1). A mid grid under 8x8 is zero-padded at the bottom
    and right up to 8x8 first (the tiny test geometries), as JAX does."""

    def __init__(self, channels: int = 1280):
        super().__init__()
        c = channels
        self.conv0 = Conv2d(c, c, 4, stride=2, padding=1)
        self.norm0 = GroupNorm(c, 32, 1e-5)
        self.conv1 = Conv2d(c, c, 4, stride=4)
        self.norm1 = GroupNorm(c, 32, 1e-5)
        self.conv_out = Conv2d(c, 1, 1)

    def forward(self, rep):
        hh, ww = rep.shape[2:]
        if hh < 8 or ww < 8:
            rep = F.pad(rep, (0, max(0, 8 - ww), 0, max(0, 8 - hh)))
        h = F.silu(self.norm0(self.conv0(rep)))
        h = F.silu(self.norm1(self.conv1(h)))
        return self.conv_out(h).mean(dim=(2, 3))


class SDGuidance(nn.Module):
    """The real / fake UNet pair and the GAN head. ``real_unet`` is frozen
    by the guidance optimizer (``train/step.py:create_stage2_states``) and
    stays in the module for checkpoint parity."""

    def __init__(self, block_channels: Sequence[int] = (320, 640, 1280, 1280),
                 context_dim: int = 768, num_train_timesteps: int = 1000,
                 min_step_percent: float = 0.02,
                 max_step_percent: float = 0.64,
                 real_guidance_scale: float = 1.75,
                 fake_guidance_scale: float = 1.0,
                 diffusion_gan: bool = True,
                 diffusion_gan_max_timestep: int = 1000,
                 cls_on_clean_image: bool = True, gan_alone: bool = False):
        super().__init__()
        self.context_dim = context_dim
        self.num_train_timesteps = num_train_timesteps
        self.min_step = int(min_step_percent * num_train_timesteps)
        self.max_step = int(max_step_percent * num_train_timesteps)
        self.real_guidance_scale = real_guidance_scale
        self.fake_guidance_scale = fake_guidance_scale
        self.diffusion_gan = diffusion_gan
        self.diffusion_gan_max_timestep = diffusion_gan_max_timestep
        self.cls_on_clean_image = cls_on_clean_image
        self.gan_alone = gan_alone
        self.real_unet = SD15UNet(block_channels=block_channels,
                                  context_dim=context_dim)
        self.fake_unet = SD15UNet(block_channels=block_channels,
                                  context_dim=context_dim)
        self.cls_pred_branch = ClsHead(block_channels[-1])
        self.alphas_cumprod = make_alphas_cumprod(num_train_timesteps)

    # -- random draws ---------------------------------------------------------

    @staticmethod
    def _draw(latents, low: int, high: int, generator: torch.Generator,
              noise: bool = True):
        b = latents.shape[0]
        t = torch.randint(low, high, (b,), generator=generator,
                          device=generator.device)
        n = (torch.randn(latents.shape, generator=generator,
                         device=generator.device, dtype=latents.dtype)
             if noise else None)
        dev = latents.device
        return t.to(dev), (None if n is None else n.to(dev))

    def _draw_cls(self, out: Draws, prefix: str, latents, generator):
        if self.diffusion_gan:
            out[f"{prefix}_t"], out[f"{prefix}_noise"] = self._draw(
                latents, 0, self.diffusion_gan_max_timestep, generator)

    def generator_draws(self, latents, generator: torch.Generator) -> Draws:
        """The generator turn's draws: ``dm_t`` in [min_step, max_step] and
        ``dm_noise``; ``cls_t`` in [0, diffusion_gan_max_timestep) and
        ``cls_noise``."""
        out: Draws = {}
        if not self.gan_alone:
            out["dm_t"], out["dm_noise"] = self._draw(
                latents, self.min_step,
                min(self.max_step + 1, self.num_train_timesteps), generator)
        if self.cls_on_clean_image:
            self._draw_cls(out, "cls", latents, generator)
        return out

    def guidance_draws(self, fake_latents, real_latents,
                       generator: torch.Generator) -> Draws:
        """The guidance turn's draws: ``fake_t`` in [0, T) and
        ``fake_noise`` for the critic's MSE; ``real_cls_*`` and
        ``fake_cls_*`` for the two GAN logits."""
        out: Draws = {}
        out["fake_t"], out["fake_noise"] = self._draw(
            fake_latents, 0, self.num_train_timesteps, generator)
        if self.cls_on_clean_image:
            self._draw_cls(out, "real_cls", real_latents, generator)
            self._draw_cls(out, "fake_cls", fake_latents, generator)
        return out

    # -- building blocks ------------------------------------------------------

    def _predict_noise(self, unet, noisy, text_emb, uncond_emb, t,
                       guidance_scale: float):
        """CFG epsilon, as one 2B forward when the scale is above 1."""
        if guidance_scale > 1.0:
            both = torch.cat([noisy, noisy])
            embs = torch.cat([uncond_emb, text_emb])
            eps_uncond, eps_text = unet(both, torch.cat([t, t]),
                                        embs).chunk(2)
            return eps_uncond + guidance_scale * (eps_text - eps_uncond)
        return unet(noisy, t, text_emb)

    def compute_cls_logits(self, image, text_emb, t=None, noise=None):
        """The realism logit (B, 1) of latents ``image``: noised at ``t``
        with ``noise`` under ``diffusion_gan`` (else at t = 0, clean)."""
        if self.diffusion_gan:
            image = add_noise(image, noise, t, self.alphas_cumprod)
        else:
            t = torch.zeros(image.shape[0], dtype=torch.int64,
                            device=image.device)
        rep = self.fake_unet(image, t, text_emb, classify=True)
        return self.cls_pred_branch(rep.float())

    # -- losses ---------------------------------------------------------------

    def distribution_matching_loss(self, latents, text_emb, uncond_emb, t,
                                   noise):
        lat32 = latents.float()
        with torch.no_grad():
            noisy = add_noise(latents.detach(), noise, t,
                              self.alphas_cumprod)
            eps_fake = self._predict_noise(self.fake_unet, noisy, text_emb,
                                           uncond_emb, t,
                                           self.fake_guidance_scale)
            x0_fake = get_x0_from_noise(noisy, eps_fake,
                                        self.alphas_cumprod, t)
            eps_real = self._predict_noise(self.real_unet, noisy, text_emb,
                                           uncond_emb, t,
                                           self.real_guidance_scale)
            x0_real = get_x0_from_noise(noisy, eps_real,
                                        self.alphas_cumprod, t)
            p_real = lat32 - x0_real
            p_fake = lat32 - x0_fake
            grad = (p_real - p_fake) / p_real.abs().mean(
                dim=(1, 2, 3), keepdim=True)
            grad = torch.nan_to_num(grad)
            target = lat32 - grad
        loss = 0.5 * ((lat32 - target) ** 2).mean()
        return loss, {"dm_gradient_norm": torch.linalg.vector_norm(grad)}

    def loss_fake(self, latents, text_emb, uncond_emb, t, noise):
        """The critic's epsilon MSE on detached latents."""
        noisy = add_noise(latents.detach(), noise, t, self.alphas_cumprod)
        eps = self._predict_noise(self.fake_unet, noisy, text_emb,
                                  uncond_emb, t, 1.0)
        return ((eps.float() - noise.float()) ** 2).mean()

    # -- the two turns --------------------------------------------------------

    def generator_forward(self, image_latents, text_emb, uncond_emb,
                          draws: Optional[Draws] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Dict[str, torch.Tensor]:
        """The generator's losses: ``loss_dm`` and ``dm_gradient_norm``
        (unless ``gan_alone``), ``gen_cls_loss`` (with
        ``cls_on_clean_image``). Gradients reach ``image_latents`` through
        the DM target and through the fake UNet's down path and the head;
        the generator turn takes gradients of its own parameters only."""
        if draws is None:
            draws = self.generator_draws(image_latents, generator)
        out = {}
        if not self.gan_alone:
            loss_dm, aux = self.distribution_matching_loss(
                image_latents, text_emb, uncond_emb, draws["dm_t"],
                draws["dm_noise"])
            out["loss_dm"] = loss_dm
            out.update(aux)
        if self.cls_on_clean_image:
            logits = self.compute_cls_logits(image_latents, text_emb,
                                             draws.get("cls_t"),
                                             draws.get("cls_noise"))
            out["gen_cls_loss"] = F.softplus(-logits).mean()
        return out

    def guidance_forward(self, fake_latents, real_latents, text_emb,
                         uncond_emb, real_text_emb,
                         draws: Optional[Draws] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
        """The critic's losses on detached latents: ``loss_fake_mean``
        and, with ``cls_on_clean_image``, ``guidance_cls_loss`` and the
        mean realism on real and fake latents."""
        if draws is None:
            draws = self.guidance_draws(fake_latents, real_latents,
                                        generator)
        fake_latents = fake_latents.detach()
        real_latents = real_latents.detach()
        out = {"loss_fake_mean": self.loss_fake(
            fake_latents, text_emb, uncond_emb, draws["fake_t"],
            draws["fake_noise"])}
        if self.cls_on_clean_image:
            on_real = self.compute_cls_logits(real_latents, real_text_emb,
                                              draws.get("real_cls_t"),
                                              draws.get("real_cls_noise"))
            on_fake = self.compute_cls_logits(fake_latents, text_emb,
                                              draws.get("fake_cls_t"),
                                              draws.get("fake_cls_noise"))
            out["guidance_cls_loss"] = (F.softplus(on_fake).mean()
                                        + F.softplus(-on_real).mean())
            out["pred_realism_on_real"] = torch.sigmoid(on_real).mean()
            out["pred_realism_on_fake"] = torch.sigmoid(on_fake).mean()
        return out
