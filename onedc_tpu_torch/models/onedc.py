"""OneDC composite model: latent codec + one-step SD UNet + VAE, its
stage-I training forward, and the bitstream decode runtime.

JAX counterpart: ``onedc_tpu/models/onedc.py`` (:41-224 ``OneDC``, with the
training forward :156-184, :226-365 ``OneDCRuntime.decode``, :467-531
``decode_batch`` and the non-pipelined ``_decode_bucket``). As in the JAX
package, x0 is recovered in f32 and the VAE decodes in the working dtype.

``OneDCRuntime`` runs on the card unless the caller names another device:
with no device and no GPU it raises, it does not drop to the CPU.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..entropy.framing import decode_i
from ..nn.diffusion import get_x0_from_noise, make_alphas_cumprod
from ..nn.unet_sd import SD15CodecUNet
from ..nn.vae import AutoencoderKL, hwio_conv_weights
from .codec import LatentCodec, nhwc
from .runtime import CodecRuntime


class OneDC(nn.Module):
    """Composite model. Submodules: vae / unet / codec."""

    def __init__(self, internal_ch: int = 512, bottleneck_ch: int = 128,
                 unet_ch_config: Sequence[int] = (512, 768, 768),
                 z_fsq_levels: Sequence[int] = (4, 4, 4, 4, 4, 4, 4),
                 force_zero_thres: Optional[float] = None,
                 ctrl_ch: int = 320, vae_ch: int = 4,
                 sd_block_channels: Sequence[int] = (320, 640, 1280, 1280),
                 context_dim: int = 768,
                 vae_block_channels: Sequence[int] = (128, 256, 512, 512),
                 vae_attn_patch: int = 16, vae_scaling_factor: float = 0.18215,
                 conditioning_timestep: int = 999,
                 num_train_timesteps: int = 1000,
                 use_codeformer: bool = False):
        super().__init__()
        if use_codeformer:
            raise NotImplementedError(
                "use_codeformer: the Codeformer, MaskGitVQGAN and Swin "
                "modules are not ported yet")
        self.vae_scaling_factor = vae_scaling_factor
        self.conditioning_timestep = conditioning_timestep
        self.vae = AutoencoderKL(vae_block_channels, vae_ch, vae_attn_patch)
        self.unet = SD15CodecUNet(
            in_ch=ctrl_ch, out_ch=vae_ch, vae_ch=vae_ch,
            block_channels=sd_block_channels, context_dim=context_dim)
        self.codec = LatentCodec(
            cond_ch=vae_ch, ctrl_ch=ctrl_ch, internal_ch=internal_ch,
            bottleneck_ch=bottleneck_ch, unet_ch_config=unet_ch_config,
            z_fsq_levels=z_fsq_levels, force_zero_thres=force_zero_thres)
        self.alphas_cumprod = make_alphas_cumprod(num_train_timesteps)

    def vae_encode_image(self, image):
        """image NCHW -> the posterior mean times the scaling factor,
        detached (``onedc_tpu/models/onedc.py:111-118``, the deterministic
        encode); the frozen encoder runs with no autograd record."""
        with torch.no_grad():
            mean, _ = self.vae.encode(image)
            return mean * self.vae_scaling_factor

    def vae_decode_image(self, latents):
        return self.vae.decode(latents / self.vae_scaling_factor)

    def forward(self, image, training: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The stage-I training forward (``onedc.py:156-184``, codeformer
        branch excluded): image (B, H, W, 3) NHWC in [-1, 1] -> (enc_dict,
        pred_image (B, H, W, 3) NHWC). ``noise`` / ``generator`` feed the
        codec's bit estimate (``LatentCodec.forward``). enc_dict holds the
        codec's keys plus "x_latent" and "x_latent_recon" (x0, f32), NCHW.
        """
        x = image.permute(0, 3, 1, 2)
        x_latent = self.vae_encode_image(x)
        enc_dict = self.codec(x, x_latent, training=training, noise=noise,
                              generator=generator)
        pred, x0 = self.generate(enc_dict["x_hat"], enc_dict["y_semantic"])
        enc_dict["x_latent"] = x_latent
        enc_dict["x_latent_recon"] = x0
        return enc_dict, nhwc(pred)

    def _one_step_x0(self, x_hat, y_semantic):
        """One UNet step at t=999 on the control tensor, x0 in f32."""
        b = x_hat.shape[0]
        context = y_semantic.flatten(2).transpose(1, 2)  # (B, hw, C)
        t = torch.full((b,), self.conditioning_timestep, dtype=torch.int32,
                       device=x_hat.device)
        eps, reduced = self.unet(x_hat, t, context)
        return get_x0_from_noise(reduced, eps, self.alphas_cumprod, t)

    def generate(self, x_hat, y_semantic):
        """Control tensor + semantic tokens -> (image NCHW, x0 f32)."""
        x0 = self._one_step_x0(x_hat, y_semantic)
        return self.vae_decode_image(x0.to(x_hat.dtype)), x0

    # staged halves of decode_device (the JAX package's pipelined serving
    # path splits the same way; a traced decode times the stages)

    def decode_device_x0(self, y_hat, z_semantic):
        """Codec finish + UNet + x0, cast to the working dtype."""
        x_hat, y_semantic = self.codec.decompress_finish(y_hat, z_semantic)
        return self._one_step_x0(x_hat, y_semantic).to(x_hat.dtype)

    def decode_device_vae(self, x0):
        return self.vae_decode_image(x0)

    def decode_device(self, y_hat, z_semantic):
        """NHWC y_hat + z_semantic -> image, NCHW."""
        return self.decode_device_vae(self.decode_device_x0(y_hat, z_semantic))


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no GPU and no device
    named is an error, not a fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return torch.device("cuda")


class OneDCRuntime:
    """Bitstream decode: ``decode(stream)`` -> (1, H, W, 3) f32 NHWC.

    ``state``: a state dict loaded with ``strict=True`` (for example from
    ``utils.convert.state_dict_from_jax``), or None to keep the model's
    weights. ``dtype=torch.bfloat16`` casts the weights once for serving
    (x0 stays f32).
    """

    def __init__(self, model: OneDC, state: Optional[Dict] = None,
                 dtype: Optional[torch.dtype] = None, device=None):
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

    def parse(self, stream: bytes) -> dict:
        return decode_i(stream, self._codec_rt.fsq.index_bits, self.ds)

    def z_indices(self, dec: dict) -> np.ndarray:
        zh, zw = dec["pad_height"] // self.ds, dec["pad_width"] // self.ds
        return self._codec_rt.fsq.unpack_indices(
            dec["bit_stream_z"], zh * zw).reshape(1, zh, zw)

    @torch.no_grad()
    def decode_padded(self, decs: List[dict],
                      trace: Optional[dict] = None) -> torch.Tensor:
        """One same-padded-size bucket -> padded images (B, H, W, 3) f32:
        one four-part loop over the bucket, then one batched
        codec-finish + UNet + VAE pass. ``trace``, if given, receives the
        host (indexes, symbols) of each step under "steps", the decoded
        latent under "y_hat", and the host ms of each stage under
        "stage_ms": "begin" (z unpack, codec begin), "updates_with_rans"
        (4 x host rANS and update), "finish_unet_x0" and "vae". A traced
        decode waits for the device at the end of each stage."""
        rt = self._codec_rt
        stage_done = self._stage_clock(trace)
        z = np.concatenate([self.z_indices(d) for d in decs])
        coders = rt.make_stream_coders([d["bit_stream_y"] for d in decs])
        steps = trace.setdefault("steps", []) if trace is not None else None
        y_hat, z_semantic = rt.run_four_part_decode(z, coders, steps,
                                                    stage_done)
        x0 = self.model.decode_device_x0(y_hat, z_semantic)
        if trace is not None:
            trace["y_hat"] = y_hat
            stage_done("finish_unet_x0")
        image = self.model.decode_device_vae(x0)
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

    def decode_batch(self, streams: Sequence[bytes]) -> List[torch.Tensor]:
        """Decode N streams, one batch per padded size (bucket); results in
        input order, each (1, H, W, 3) f32."""
        decs = [self.parse(s) for s in streams]
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, d in enumerate(decs):
            buckets.setdefault((d["pad_height"], d["pad_width"]),
                               []).append(i)
        out: List[Optional[torch.Tensor]] = [None] * len(decs)
        for idxs in buckets.values():
            preds = self.decode_padded([decs[i] for i in idxs])
            for row, i in enumerate(idxs):
                out[i] = self._unpad(preds[row:row + 1], decs[i])
        return out
