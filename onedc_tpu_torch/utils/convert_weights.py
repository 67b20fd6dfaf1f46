"""Convert torch weight files into the JAX package's safetensors layouts.

JAX counterpart: ``onedc_tpu/utils/convert_weights.py`` (the
``inception``, ``dists``, ``lpips``, ``onedc`` and ``guidance``
subcommands). The files it writes have the JAX package's converted layout
("/"-joined keys, HWIO kernels), so a file written by either package
loads in the other. Weights must arrive on disk; nothing is downloaded.

  # pytorch-fid / torch-fidelity pt_inception-2015-12-05 state dict
  python -m onedc_tpu_torch.utils.convert_weights inception \\
      --src pt_inception.pth --out inception.safetensors

  # torchvision VGG16 features + DISTS package alpha/beta buffers
  python -m onedc_tpu_torch.utils.convert_weights dists \\
      --vgg vgg16.pth --dists weights.pt --out dists.safetensors

  # torchvision VGG16 features + LPIPS linear heads
  python -m onedc_tpu_torch.utils.convert_weights lpips \\
      --vgg vgg16.pth --lins lpips_lins.pth --out lpips.safetensors

  # the reference's OneDC release (model.safetensors, model_1.safetensors)
  # [+ a diffusers SD2.1 VAE, a Codeformer] -> the OneDC tree, the
  # inference CLI's ckpt= file; model.* overrides as in JAX
  python -m onedc_tpu_torch.utils.convert_weights onedc \\
      --unet model.safetensors --codec model_1.safetensors \\
      [--vae vae.safetensors] [--codeformer cf.safetensors] \\
      --out onedc.safetensors \\
      [model.key=value ...] [seed=N device=cpu]

  # a stage-II SDGuidance state dict (model_2.safetensors) -> the
  # SDGuidance tree ("/"-joined, HWIO), guidance.* overrides as in JAX
  python -m onedc_tpu_torch.utils.convert_weights guidance \\
      --src model_2.safetensors --out guidance.safetensors

The guidance file holds what the source fills: ``fake_unet``, the head,
and ``real_unet`` where the source carries it (JAX writes its initial
values for a missing ``real_unet``; the port has no flax initialiser to
draw them). The onedc file holds every tensor of the model: where no
source fills one (the VAE of a release without ``--vae``), JAX writes its
flax initial values, the port the inference CLI's seeded random weights
(``seed``, default 0, drawn on ``device``, the card unless ``device=cpu``),
so that ``ckpt=`` of the file decodes bit for bit as ``checkpoint_path=``
of the release does under the same seed and device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .safetensors import save_safetensors


def _torch_load(path):
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: np.asarray(v) for k, v in obj.items()}


def convert_inception(src, out):
    from ..nn.inception import convert_torch_inception
    save_safetensors(convert_torch_inception(_torch_load(src)), out)


def convert_dists(vgg, dists, out):
    from ..nn.dists import convert_torch_dists
    vgg_state = _torch_load(vgg)
    d = _torch_load(dists)
    if "alpha" not in d or "beta" not in d:
        raise KeyError(f"{dists}: no alpha / beta in {sorted(d)[:5]}")
    save_safetensors(convert_torch_dists(vgg_state, d["alpha"], d["beta"]),
                     out)


def convert_lpips(vgg, lins, out):
    from ..nn.lpips import convert_torch_vgg16
    vgg_state = _torch_load(vgg)
    lin_state = _torch_load(lins)
    # lpips package layout: lin{k}.model.1.weight
    lin_weights = []
    for k in range(5):
        for name in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
            if name in lin_state:
                lin_weights.append(lin_state[name])
                break
        else:
            raise KeyError(f"no linear head {k} in {sorted(lin_state)[:5]}")
    save_safetensors(convert_torch_vgg16(vgg_state, lin_weights), out)


def convert_onedc(unet, codec, vae, codeformer, out, overrides=()):
    """``port_onedc_checkpoint`` of the given files onto a ``OneDC`` built
    from the ``model.*`` overrides on the meta device, written in the JAX
    tree's layout. Tensors no file fills: the seeded random weights of
    ``eval/inference.py:load_params`` (``seed``, ``device``)."""
    from ..config import parse_cli_overrides
    from ..models.onedc import OneDC, init_random_weights
    from .convert import flat_jax_from_state_dict
    from .device import resolve_device
    from .port_torch import port_onedc_checkpoint

    cfg = parse_cli_overrides(overrides)
    with torch.device("meta"):
        model = OneDC(**dict(cfg.get("model", {})))
    state = port_onedc_checkpoint(
        unet_path=unet, codec_path=codec, vae_path=vae,
        codeformer_path=codeformer, reference=model.state_dict())
    unfilled = [k for k, v in state.items() if v.is_meta]
    if unfilled:
        device = resolve_device(cfg.get("device"))
        model.to_empty(device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(cfg.get("seed", 0)))
        init_random_weights(model, gen)
        init = model.state_dict()
        state.update({k: init[k] for k in unfilled})
        del model, init
    save_safetensors(flat_jax_from_state_dict(state), out)


def convert_guidance(src, out, overrides=()):
    """``port_guidance_checkpoint`` of ``src`` onto an ``SDGuidance`` built
    from the ``guidance.*`` overrides (on the meta device: keys and shapes
    only), written in the JAX tree's layout."""
    from ..config import parse_cli_overrides
    from ..models.dmd import SDGuidance
    from .convert import flat_jax_from_state_dict
    from .port_torch import port_guidance_checkpoint

    cfg = parse_cli_overrides(overrides)
    with torch.device("meta"):
        guidance = SDGuidance(**dict(cfg.get("guidance", {})))
    state = port_guidance_checkpoint(src, guidance.state_dict())
    save_safetensors(flat_jax_from_state_dict(
        {k: v for k, v in state.items() if not v.is_meta}), out)


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("inception")
    s.add_argument("--src", required=True)
    s.add_argument("--out", required=True)

    s = sub.add_parser("dists")
    s.add_argument("--vgg", required=True)
    s.add_argument("--dists", required=True)
    s.add_argument("--out", required=True)

    s = sub.add_parser("lpips")
    s.add_argument("--vgg", required=True)
    s.add_argument("--lins", required=True)
    s.add_argument("--out", required=True)

    s = sub.add_parser("onedc")
    s.add_argument("--unet", default=None)
    s.add_argument("--codec", default=None)
    s.add_argument("--vae", default=None)
    s.add_argument("--codeformer", default=None)
    s.add_argument("--out", required=True)

    s = sub.add_parser("guidance")
    s.add_argument("--src", required=True)
    s.add_argument("--out", required=True)

    args, overrides = p.parse_known_args(argv)
    if overrides and args.cmd not in ("onedc", "guidance"):
        p.error(f"unrecognized arguments: {' '.join(overrides)}")
    if args.cmd == "inception":
        convert_inception(args.src, args.out)
    elif args.cmd == "dists":
        convert_dists(args.vgg, args.dists, args.out)
    elif args.cmd == "lpips":
        convert_lpips(args.vgg, args.lins, args.out)
    elif args.cmd == "onedc":
        convert_onedc(args.unet, args.codec, args.vae, args.codeformer,
                      args.out, overrides)
    elif args.cmd == "guidance":
        convert_guidance(args.src, args.out, overrides)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
