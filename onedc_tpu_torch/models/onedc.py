"""OneDC composite model: latent codec + one-step SD UNet + VAE, its
stage-I training forward, and the bitstream runtime (encode and decode).

JAX counterpart: ``onedc_tpu/models/onedc.py`` (:41-224 ``OneDC``, with the
training forward :156-184, its Codeformer distillation (``use_codeformer``:
``models/codeformer.py`` on y_semantic against the frozen ``nn/vqgan.py``
tokenizer of the half-size image) and the device halves :188-223; :226-367
``OneDCRuntime.encode`` / ``decode``, :385-465 ``encode_batch`` /
``encode_many``, :467-563 ``decode_batch`` with the pipelined
``_decode_bucket_pipelined``, :313 ``set_params``). As in the JAX
package, x0 is recovered in f32 and the VAE decodes in the working
dtype; encode uses the VAE posterior mean.
``z_only=True`` is the extreme-low-bpp model (``configs/
inference_exlow.yaml``): its container carries the z indices only.

``use_large_vae=False`` decodes through the taesd TinyVAE (JAX :60-65,
96-98, 121-124; latents unscaled) while encode stays on the large VAE
encoder; ``OneDCRuntime(vae="tiny")`` selects it (JAX :234-261), and
``ensure_tiny_vae_params`` grafts a seeded random TinyVAE where no taesd
weights are given (JAX :566).

``OneDCRuntime(quant="w8a8")`` runs the decode programs' UNet, VAE decoder
and TinyVAE in the w8a8 serving mode (``nn/quant.py``; JAX :234-305):
``decode``, ``decode_batch`` (the pipelined programs too), the z-only
decode and the exported decode programs. Encode, the four-part prior loop
and the codec finish stay exact, so its containers and y_hat are the exact
runtime's.

``OneDCRuntime`` runs on the card unless the caller names another device:
with no device and no GPU it raises, it does not drop to the CPU. Its
device arithmetic runs under ``utils.numerics.pinned_numerics``: every
encode entry point computes its plan in ``write_plan`` and every decode
entry point its images in ``decode_padded``, the two pinned methods.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..entropy.bound import uniform_noise
from ..entropy.framing import get_padding_size
from ..nn import quant as q8
from ..nn.diffusion import get_x0_from_noise, make_alphas_cumprod
from ..nn.unet_sd import SD15CodecUNet
from ..nn.vae import AutoencoderKL, TinyVaeDecoder, hwio_conv_weights
from ..nn.vqgan import MaskGitVQGAN
from ..serving.encoder import pad_replicate
from ..serving.pipeline import DecodePrograms, pipelined_decode
from ..utils.device import resolve_device  # noqa: F401  (re-exported)
from ..utils.numerics import pinned
from ..utils.remat import rematerialized
from .codec import LatentCodec, nchw, nhwc
from .codeformer import Codeformer, codeformer_losses
from .runtime import (
    WRITE_KEYS,
    CodecRuntime,
    decode_begin,
    decode_update,
    host_arrays,
)


class OneDC(nn.Module):
    """Composite model. Submodules: vae / unet / codec, and with
    ``use_codeformer`` codeformer / vqgan."""

    def __init__(self, internal_ch: int = 512, bottleneck_ch: int = 128,
                 unet_ch_config: Sequence[int] = (512, 768, 768),
                 z_fsq_levels: Sequence[int] = (4, 4, 4, 4, 4, 4, 4),
                 z_only: bool = False,
                 force_zero_thres: Optional[float] = None,
                 ctrl_ch: int = 320, vae_ch: int = 4,
                 sd_block_channels: Sequence[int] = (320, 640, 1280, 1280),
                 context_dim: int = 768,
                 vae_block_channels: Sequence[int] = (128, 256, 512, 512),
                 vae_attn_patch: int = 16, vae_scaling_factor: float = 0.18215,
                 use_large_vae: bool = True, tiny_vae_ch: int = 64,
                 conditioning_timestep: int = 999,
                 num_train_timesteps: int = 1000,
                 use_codeformer: bool = False,
                 codeformer_codebook: int = 1024,
                 codeformer_window: int = 16, vqgan_hidden: int = 128):
        super().__init__()
        self.use_codeformer = use_codeformer
        self.vae_scaling_factor = vae_scaling_factor
        self.conditioning_timestep = conditioning_timestep
        self.use_large_vae = use_large_vae
        self.tiny_vae_ch = tiny_vae_ch
        self.vae_ch = vae_ch
        self.vae = AutoencoderKL(vae_block_channels, vae_ch, vae_attn_patch)
        if not use_large_vae:
            self.vae_tiny_dec = TinyVaeDecoder(tiny_vae_ch, latent_ch=vae_ch)
        self.unet = SD15CodecUNet(
            in_ch=ctrl_ch, out_ch=vae_ch, vae_ch=vae_ch,
            block_channels=sd_block_channels, context_dim=context_dim)
        self.codec = LatentCodec(
            cond_ch=vae_ch, ctrl_ch=ctrl_ch, internal_ch=internal_ch,
            bottleneck_ch=bottleneck_ch, unet_ch_config=unet_ch_config,
            z_fsq_levels=z_fsq_levels, force_zero_thres=force_zero_thres,
            z_only=z_only)
        self.alphas_cumprod = make_alphas_cumprod(num_train_timesteps)
        if use_codeformer:
            # the semantic distillation of stage I (onedc.py:68-75, 99-107):
            # the frozen VQGAN tokenizes the half-size image, the
            # Codeformer predicts its codes from y_semantic
            self.codeformer = Codeformer(in_ch=context_dim,
                                         codebook_size=codeformer_codebook,
                                         window_size=codeformer_window)
            self.vqgan = MaskGitVQGAN(hidden=vqgan_hidden,
                                      num_embeddings=codeformer_codebook,
                                      with_decoder=False)

    def vae_encode_image(self, image):
        """image NCHW -> the posterior mean times the scaling factor,
        detached (``onedc_tpu/models/onedc.py:111-118``, the deterministic
        encode); the frozen encoder runs with no autograd record."""
        with torch.no_grad():
            mean, _ = self.vae.encode(image)
            return mean * self.vae_scaling_factor

    def vae_decode_image(self, latents, large: Optional[bool] = None):
        """Latents -> image NCHW through the large VAE, or the TinyVAE
        where ``large`` is False (None: the model's ``use_large_vae``)."""
        if not (self.use_large_vae if large is None else large):
            # taesd's scaling factor is 1.0: the latents pass unscaled
            return self.vae_tiny_dec(latents)
        return self.vae.decode(latents / self.vae_scaling_factor)

    def bit_noise(self, image, generator: torch.Generator) -> torch.Tensor:
        """The codec's U(-0.5, 0.5) training noise for ``image`` (B, H, W,
        3): y's shape in the JAX layout, (B, H/16, W/16, C), drawn from
        ``generator``."""
        b, h, w, _ = image.shape
        return uniform_noise((b, h // 16, w // 16, self.codec.bottleneck_ch),
                             generator, image.device,
                             self.codec.compute_dtype)

    @torch.no_grad()
    def vqgan_targets(self, x):
        """The distillation targets of image x NCHW in [-1, 1]: the frozen
        VQGAN's (quantized latents, indices) of the image resized to half
        its size, bilinear with antialiasing as ``jax.image.resize`` does
        it, and shifted to [0, 1]; no autograd record (JAX's
        ``stop_gradient``)."""
        h, w = x.shape[2:]
        small = F.interpolate(x, size=(h // 2, w // 2), mode="bilinear",
                              align_corners=False, antialias=True)
        return self.vqgan.encode(small * 0.5 + 0.5)

    def forward(self, image, training: bool = False,
                noise: Optional[torch.Tensor] = None,
                remat: bool = False):
        """The stage-I training forward (``onedc.py:156-184``): image (B,
        H, W, 3) NHWC in [-1, 1] -> (enc_dict, pred_image (B, H, W, 3)
        NHWC). ``noise`` (drawn by ``bit_noise``, outside any rematerialised
        region) feeds the codec's bit estimate in training
        (``LatentCodec.forward``). enc_dict holds the
        codec's keys plus "x_latent" and "x_latent_recon" (x0, f32), NCHW,
        and with the Codeformer "code_ce_loss" and "code_mse_loss".

        ``remat``: the part that autograd records (codec, UNet, VAE
        decoder, Codeformer) runs rematerialised (``utils/remat.py``); the
        frozen VAE encoder and the VQGAN run before it, without autograd.
        """
        x = image.permute(0, 3, 1, 2)
        x_latent = self.vae_encode_image(x)
        targets = self.vqgan_targets(x) if self.use_codeformer else None
        if remat and torch.is_grad_enabled():
            enc_dict, pred = rematerialized(self._recorded_forward, x,
                                            x_latent, targets, training,
                                            noise)
        else:
            enc_dict, pred = self._recorded_forward(x, x_latent, targets,
                                                    training, noise)
        return enc_dict, nhwc(pred)

    @torch.no_grad()
    def training_latents(self, image, noise: Optional[torch.Tensor] = None):
        """(x_latent, x_latent_recon) of the training forward on image (B,
        H, W, 3), NCHW, without autograd and without the VAE decode that
        only the image needs: the stage-II steps that feed the critic
        without a generator update (the JAX trainer's ``_gen_latents``,
        whose unused image XLA drops)."""
        x = image.permute(0, 3, 1, 2)
        x_latent = self.vae_encode_image(x)
        enc_dict = self.codec(x, x_latent, training=True, noise=noise)
        return x_latent, self._one_step_x0(enc_dict["x_hat"],
                                           enc_dict["y_semantic"])

    def _recorded_forward(self, x, x_latent, targets, training: bool, noise):
        """Codec, one-step generation and the Codeformer's losses: (enc_dict,
        pred NCHW)."""
        enc_dict = self.codec(x, x_latent, training=training, noise=noise)
        pred, x0 = self.generate(enc_dict["x_hat"], enc_dict["y_semantic"])
        enc_dict["x_latent"] = x_latent
        enc_dict["x_latent_recon"] = x0
        if targets is not None:
            quant, idx = targets
            logits, probs = self.codeformer(enc_dict["y_semantic"])
            ce, mse = codeformer_losses(logits, probs, idx, quant,
                                        self.vqgan.codebook().detach())
            enc_dict["code_ce_loss"] = ce
            enc_dict["code_mse_loss"] = mse
        return enc_dict, pred

    def _one_step_x0(self, x_hat, y_semantic):
        """One UNet step at t=999 on the control tensor, x0 in f32."""
        b = x_hat.shape[0]
        context = y_semantic.flatten(2).transpose(1, 2)  # (B, hw, C)
        t = torch.full((b,), self.conditioning_timestep, dtype=torch.int32,
                       device=x_hat.device)
        eps, reduced = self.unet(x_hat, t, context)
        return get_x0_from_noise(reduced, eps, self.alphas_cumprod, t)

    def generate(self, x_hat, y_semantic, large: Optional[bool] = None):
        """Control tensor + semantic tokens -> (image NCHW, x0 f32); the
        VAE as ``vae_decode_image`` picks it."""
        x0 = self._one_step_x0(x_hat, y_semantic)
        return self.vae_decode_image(x0.to(x_hat.dtype), large), x0

    def encode_device(self, image_padded):
        """The device half of encode: image (B, 3, H, W) padded to a
        multiple of 64 -> the codec's write plan (``LatentCodec.
        compress``), cond = the VAE posterior mean."""
        return self.codec.compress(image_padded,
                                   self.vae_encode_image(image_padded))

    def decode_device_z_only(self, z_indices, large: Optional[bool] = None):
        """z indices (B, h, w) -> image NCHW, through the z-only codec
        decode, the UNet and the VAE."""
        x_hat, y_semantic = self.codec.decompress_z_only(z_indices)
        return self.generate(x_hat, y_semantic, large)[0]

    # staged halves of decode_device (the JAX package's pipelined serving
    # path splits the same way; a traced decode times the stages)

    def decode_device_x0(self, y_hat, z_semantic):
        """Codec finish + UNet + x0, cast to the working dtype."""
        x_hat, y_semantic = self.codec.decompress_finish(y_hat, z_semantic)
        return self._one_step_x0(x_hat, y_semantic).to(x_hat.dtype)

    def decode_device_vae(self, x0, large: Optional[bool] = None):
        return self.vae_decode_image(x0, large)

    def decode_device(self, y_hat, z_semantic):
        """NHWC y_hat + z_semantic -> image, NCHW."""
        return self.decode_device_vae(self.decode_device_x0(y_hat, z_semantic))


class OneDCRuntime:
    """The bitstream runtime: ``encode(image)`` -> (stream, bpp dict);
    ``decode(stream)`` -> (1, H, W, 3) f32 NHWC; batched ``encode_batch``,
    ``encode_many`` and ``decode_batch``. Images are NHWC in [-1, 1].

    ``state``: a state dict loaded with ``strict=True`` (for example from
    ``utils.convert.state_dict_from_jax``), or None to keep the model's
    weights. ``dtype=torch.bfloat16`` casts the weights once for serving
    (x0 stays f32). ``vae="tiny"`` decodes through the model's TinyVAE
    (graft one with ``ensure_tiny_vae_params``), ``vae="large"`` through
    the large VAE; None takes the model's ``use_large_vae``. The choice is
    the runtime's (``use_large_vae``), not the model's: one model serves a
    runtime of each kind, as the JAX package's ``model.clone`` allows.
    Encode always runs the large VAE encoder. ``quant="w8a8"`` runs the
    decode programs' quality stages in the w8a8 mode (``quantized``); the
    mode too is the runtime's, and one model serves both kinds.
    """

    def __init__(self, model: OneDC, state: Optional[Dict] = None,
                 dtype: Optional[torch.dtype] = None, device=None,
                 vae: Optional[str] = None, quant: Optional[str] = None):
        if vae not in (None, "large", "tiny"):
            raise ValueError(f"unknown vae mode {vae!r}")
        if quant not in (None, "w8a8"):
            raise ValueError(f"unknown quant mode {quant!r}")
        self.use_large_vae = (model.use_large_vae if vae is None
                              else vae == "large")
        if not self.use_large_vae and not hasattr(model, "vae_tiny_dec"):
            raise ValueError("vae='tiny' needs TinyVAE weights: see "
                             "ensure_tiny_vae_params")
        self.device = resolve_device(device)
        if state is not None:
            model.load_state_dict(state, strict=True)
        model = model.to(device=self.device, dtype=dtype)
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        hwio_conv_weights(model.vae)
        model.eval().requires_grad_(False)
        self.model = model
        self.dtype = dtype if dtype is not None else torch.float32
        model.codec.compute_dtype = self.dtype
        self._codec_rt = CodecRuntime(model.codec, self.device)
        self.ds = model.codec.ds
        self.z_only = model.codec.z_only
        self.quant = quant
        self._w8a8 = q8.w8a8_table(model) if quant == "w8a8" else None

    def quantized(self, fn):
        """``fn`` run in the runtime's quant mode: as it is when exact,
        inside ``nn.quant.w8a8_scope`` of the model's in-scope modules for
        w8a8. Every decode program goes through it; encode does not."""
        return fn if self._w8a8 is None else q8.scoped(self._w8a8, fn)

    def set_params(self, state: Dict) -> None:
        """Swap in the weights of ``state`` (``strict=True``), as the JAX
        ``set_params`` (:313) swaps a tree: each tensor is copied into the
        runtime's parameter, on its device, in its dtype and memory layout
        (channels_last on the card, the VAE convs' HWIO), so the programs
        run as before on the new values (stream calibration, checkpoint
        reload)."""
        self.model.load_state_dict(state, strict=True)

    # -- encode -------------------------------------------------------------

    def pad(self, images) -> torch.Tensor:
        """(B, H, W, 3) images in [-1, 1], torch or numpy -> (B, 3, H', W')
        on the runtime's device, in its dtype, replicate-padded right and
        bottom to multiples of 64 (cast before padding, as in the JAX
        package)."""
        images = torch.as_tensor(images, device=self.device).to(self.dtype)
        _, h, w, _ = images.shape
        return nchw(pad_replicate(images, get_padding_size(h, w, self.ds)))

    @pinned
    @torch.no_grad()
    def write_plan(self, images) -> dict:
        """The device half of encode for a batch of same-size images (B,
        H, W, 3): ``OneDC.encode_device`` of the padded batch."""
        return self.model.encode_device(self.pad(images))

    def _fetch(self, out: dict):
        """Start the copy of a plan's host keys to the host: (host tensors
        by key, the event that marks the copies done, or None on the
        CPU). On the card the copies go to pinned memory without blocking
        the host."""
        keys = ("z_indices",) if self.z_only else WRITE_KEYS
        if self.device.type != "cuda":
            return {k: out[k] for k in keys}, None

        def copy(t):
            if isinstance(t, tuple):
                return tuple(copy(a) for a in t)
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True
                               ).copy_(t, non_blocking=True)
        host = {k: copy(out[k]) for k in keys}
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _write_chunk_streams(self, fetched, sel, results, w: int, h: int,
                             caps, fp=None):
        """The host half of a batched encode: wait for the chunk's copies,
        then write one container per row; row j goes to results[sel[j]]."""
        host, event = fetched
        if event is not None:
            event.synchronize()
        host = {k: host_arrays(v) for k, v in host.items()}
        rt = self._codec_rt
        for j, i in enumerate(sel):
            if self.z_only:
                results[i] = rt.encode_z_only(host["z_indices"][j:j + 1], w,
                                              h, fp, caps[j])
                continue
            per = {k: tuple(a[j:j + 1] for a in v) if isinstance(v, tuple)
                   else v[j:j + 1] for k, v in host.items()}
            results[i] = rt.write_streams(per, w, h, fp, caps[j])
        return results

    @torch.no_grad()
    def encode(self, image, fp=None, caption: str = ""
               ) -> Tuple[bytes, Dict[str, float]]:
        """image (1, H, W, 3) in [-1, 1], torch or numpy -> (container
        bytes, bpp dict); the container is also written to ``fp`` if
        given. ``caption`` rides the container."""
        _, h, w, _ = image.shape
        out = self.write_plan(image)
        return self._write_chunk_streams(self._fetch(out), [0], [None], w,
                                         h, [caption], fp)[0]

    @torch.no_grad()
    def encode_batch(self, images) -> List[Tuple[bytes, Dict[str, float]]]:
        """N same-size images (N, H, W, 3) as one device batch, then one
        container per image: [(stream, bpp dict)] in input order."""
        n, h, w, _ = images.shape
        out = self.write_plan(images)
        return self._write_chunk_streams(self._fetch(out), list(range(n)),
                                         [None] * n, w, h, [""] * n)

    @torch.no_grad()
    def encode_many(self, images, captions=None,
                    chunk: Optional[int] = None
                    ) -> List[Tuple[bytes, Dict[str, float]]]:
        """A list of (1, H, W, 3) images, bucketed by size and encoded in
        device chunks of ``chunk`` (default ``ONEDC_PIPELINE_CHUNK``, 8):
        every chunk's device half and its copy to the host are queued
        before any host work, then each chunk's containers are written
        once its copies are done, while the card encodes later chunks.
        [(stream, bpp dict)] in input order."""
        chunk = chunk or int(os.environ.get("ONEDC_PIPELINE_CHUNK", "8"))
        caps = list(captions) if captions is not None else [""] * len(images)
        if len(caps) != len(images):
            raise ValueError(f"{len(caps)} captions for {len(images)} images")
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, im in enumerate(images):
            buckets.setdefault(tuple(im.shape[1:3]), []).append(i)
        results: List = [None] * len(images)
        queued = []
        for (h, w), idxs in buckets.items():
            for c0 in range(0, len(idxs), chunk):
                sel = idxs[c0:c0 + chunk]
                batch = torch.cat([torch.as_tensor(images[i]) for i in sel])
                queued.append((sel, h, w, self._fetch(
                    self.write_plan(batch))))
        for sel, h, w, fetched in queued:
            self._write_chunk_streams(fetched, sel, results, w, h,
                                      [caps[i] for i in sel])
        return results

    # -- decode -------------------------------------------------------------

    def parse(self, stream: bytes) -> dict:
        return self._codec_rt.parse(stream)

    def z_indices(self, dec: dict) -> np.ndarray:
        return self._codec_rt.z_indices(dec)

    @pinned
    @torch.no_grad()
    def decode_padded(self, decs: List[dict],
                      trace: Optional[dict] = None) -> torch.Tensor:
        """One same-padded-size bucket -> padded images (B, H, W, 3) f32:
        one four-part loop over the bucket, then one batched
        codec-finish + UNet + VAE pass (z-only: one batched z-only decode).
        ``trace``, if given (lambda model), receives the host (indexes,
        symbols) of each step under "steps", the decoded latent under
        "y_hat", and the host ms of each stage under "stage_ms": "begin"
        (z unpack, codec begin), "updates_with_rans" (4 x host rANS and
        update), "finish_unet_x0" and "vae". A traced decode waits for the
        device at the end of each stage."""
        stage_done = self._stage_clock(trace)
        z = np.concatenate([self.z_indices(d) for d in decs])
        if self.z_only:
            image = self.quantized(self.model.decode_device_z_only)(
                torch.from_numpy(z).to(self.device), self.use_large_vae)
            return nhwc(image).float()
        rt = self._codec_rt
        coders = rt.make_stream_coders([d["bit_stream_y"] for d in decs])
        steps = trace.setdefault("steps", []) if trace is not None else None
        y_hat, z_semantic = rt.run_four_part_decode(z, coders, steps,
                                                    stage_done)
        x0 = self.quantized(self.model.decode_device_x0)(y_hat, z_semantic)
        if trace is not None:
            trace["y_hat"] = y_hat
            stage_done("finish_unet_x0")
        image = self.quantized(self.model.decode_device_vae)(
            x0, self.use_large_vae)
        if trace is not None:
            stage_done("vae")
        return nhwc(image).float()

    def _stage_clock(self, trace: Optional[dict]):
        """None, or a function that records under trace["stage_ms"] the
        host ms since its previous call (or since this one) once the device
        is done."""
        if trace is None:
            return None
        stage_ms = trace["stage_ms"] = {}
        last = [time.perf_counter()]

        def stage_done(stage: str):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            stage_ms[stage] = (now - last[0]) * 1e3
            last[0] = now
        return stage_done

    @staticmethod
    def _unpad(pred: torch.Tensor, dec: dict) -> torch.Tensor:
        pl, pr, pt, pb = dec["pad_tuple"]
        h = dec["pad_height"] - pt - pb
        w = dec["pad_width"] - pl - pr
        return pred[:, pt:pt + h, pl:pl + w, :]

    def decode(self, stream: bytes, trace: Optional[dict] = None
               ) -> torch.Tensor:
        """Stream -> reconstructed image (1, H, W, 3), f32."""
        dec = self.parse(stream)
        return self._unpad(self.decode_padded([dec], trace), dec)

    @pinned
    @torch.no_grad()
    def decode_batch(self, streams: Sequence[bytes]) -> List[torch.Tensor]:
        """Decode N streams, bucketed by padded size; results in input
        order, each (1, H, W, 3) f32. A bucket of more than one lambda
        stream runs the pipelined serving schedule
        (``serving/pipeline.py``: chunks of ``ONEDC_PIPELINE_CHUNK``, 8,
        ``ONEDC_PIPELINE_DEPTH``, 3, in flight, the VAE in sub-batches of
        ``ONEDC_VAE_CHUNK``, 8), as the JAX ``decode_batch`` (:467-563)
        does; a one-stream bucket runs ``decode_padded``, and the z-only
        model decodes in chunks of ``ONEDC_PIPELINE_CHUNK``."""
        decs = [self.parse(s) for s in streams]
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, d in enumerate(decs):
            buckets.setdefault((d["pad_height"], d["pad_width"]),
                               []).append(i)
        out: List[Optional[torch.Tensor]] = [None] * len(decs)
        for (ph, pw), idxs in buckets.items():
            bucket = [decs[i] for i in idxs]
            if self.z_only or len(idxs) == 1:
                chunk = int(os.environ.get("ONEDC_PIPELINE_CHUNK", "8"))
                preds = torch.cat([self.decode_padded(bucket[c0:c0 + chunk])
                                   for c0 in range(0, len(idxs), chunk)])
            else:
                preds = nhwc(self._decode_pipelined(
                    bucket, ph // self.ds, pw // self.ds)).float()
            for row, i in enumerate(idxs):
                out[i] = self._unpad(preds[row:row + 1], decs[i])
        return out

    def decode_programs(self) -> DecodePrograms:
        """The staged decode as the pipelined schedule dispatches it: the
        prior programs one row at a time (``models/runtime.py``), then
        ``decode_device_x0`` and ``decode_device_vae`` on the chunk, in the
        runtime's quant mode."""
        model, codec = self.model, self.model.codec
        return DecodePrograms(
            begin=lambda z: decode_begin(codec, z),
            update=[(lambda yq, m, yh, c, _s=s: decode_update(
                codec, _s, yq, m, yh, c)) for s in range(4)],
            x0=self.quantized(model.decode_device_x0),
            vae=self.quantized(lambda x0: model.decode_device_vae(
                x0, self.use_large_vae)))

    def _decode_pipelined(self, decs: List[dict], zh: int, zw: int
                          ) -> torch.Tensor:
        """One bucket through ``pipelined_decode``: padded images (N, 3,
        H, W) in the working dtype."""
        rt = self._codec_rt
        return pipelined_decode(
            self.decode_programs(), rt.make_stream_coders,
            lambda b: rt.fsq.unpack_indices(b, zh * zw), decs, zh, zw,
            self.device)


@torch.no_grad()
def init_random_weights(module: nn.Module, generator: torch.Generator,
                        gain: float = 0.5) -> None:
    """Seeded weights in place, drawn on the generator's device in
    parameter order: conv / linear weights gain * N(0, 1/fan_in), norm
    weights 1 + N(0, 0.1^2), biases N(0, 0.1^2)."""
    for name, p in module.named_parameters():
        noise = torch.randn(p.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
        if name.endswith("bias"):
            p.copy_(0.1 * noise)
        elif p.dim() == 1:  # GroupNorm / LayerNorm weight
            p.copy_(1 + 0.1 * noise)
        else:
            fan_in = p[0].numel()
            p.copy_(gain * noise / fan_in ** 0.5)


def ensure_tiny_vae_params(model: OneDC, generator: torch.Generator
                           ) -> OneDC:
    """``model`` with a TinyVAE decoder: its own if it has one, else a new
    one on the model's device with seeded random weights from
    ``generator``. The taesd weights are an outside artifact; random ones
    serve smoke runs only."""
    if hasattr(model, "vae_tiny_dec"):
        return model
    device = next(model.parameters()).device
    tiny = TinyVaeDecoder(model.tiny_vae_ch, latent_ch=model.vae_ch).to(device)
    init_random_weights(tiny, generator)
    model.vae_tiny_dec = tiny
    return model
