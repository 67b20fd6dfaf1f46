"""Inference CLI of the lambda-family models: per image, encode -> .bin ->
decode -> PNG, with bpp reports.

JAX counterpart: ``onedc_tpu/eval/inference.py`` (``build_model``,
``load_params``, ``Evaluator`` with ``evaluate``, ``evaluate_batched``
for ``--serving``, ``decode_only`` for ``--decoder_only``, and ``main``),
the reference's ``src/inference.py``. ``--decoder_only`` decodes
``.bin`` files in a fresh ``Evaluator``: the bitstream alone suffices.

Weights, one of:
- ``ckpt=FILE``: a safetensors file of the JAX param tree
  (``utils/convert.py:state_dict_from_safetensors``);
- ``checkpoint_path=DIR``: the reference's release, ``model.safetensors``
  (SD1.5 UNet + LoRA) and ``model_1.safetensors`` (codec), ported on load
  (``utils/port_torch.py``), with ``vae_ckpt=FILE`` for the diffusers
  SD2.1 VAE, which the release does not carry;
- neither: seeded random weights (smoke runs).
``vae=tiny`` decodes through the TinyVAE, with ``tiny_vae_ckpt=FILE``
(a safetensors file of its JAX param tree) or seeded random weights.

Reports: ``bpp_detail.csv`` and ``bpp_summary.csv``, in pandas' column
order (the JAX CLI's xlsx copies need pandas and are not written).
The CLI runs on the card unless the config says ``device: cpu``.

Usage:
  python -m onedc_tpu_torch.eval.inference \\
      --config configs/inference_lambda.yaml checkpoint_path=DIR \\
      vae_ckpt=VAE.safetensors dataset_path=IMAGES [key.path=value ...] \\
      [--serving | --decoder_only --decoder_bin_path BIN_OR_DIR]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time
from pathlib import Path
from typing import Dict, List, Mapping

import torch

from ..config import load_config
from ..data.images import ImageFolderDataset, save_image
from ..entropy.framing import read_from_file, write_to_file
from ..models.onedc import (
    OneDC,
    OneDCRuntime,
    ensure_tiny_vae_params,
    init_random_weights,
    resolve_device,
)
from ..nn.vae import TinyVaeDecoder
from ..utils.convert import state_dict_from_safetensors
from ..utils.logging import AvgDict, get_logger
from ..utils.port_torch import port_onedc_checkpoint

log = get_logger("onedc_tpu_torch.inference")


def build_model(cfg: Mapping) -> OneDC:
    """The config's OneDC on the ``meta`` device: ``load_params`` gives it
    storage and weights."""
    with torch.device("meta"):
        return OneDC(**dict(cfg.get("model") or {}))


def _seeded(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def load_params(model: OneDC, cfg: Mapping, device: torch.device) -> OneDC:
    """``model`` on ``device`` in f32, with seeded random weights
    (``seed``) overwritten by the config's checkpoint: ``ckpt`` (every
    tensor) or ``checkpoint_path`` (UNet and codec complete, and the VAE
    from ``vae_ckpt`` if given). Both sources at once raise."""
    ckpt = cfg.get("ckpt")
    ref_dir = cfg.get("checkpoint_path")
    if ckpt and ref_dir:
        raise ValueError(
            "both ckpt= and checkpoint_path= given - ambiguous weight "
            "source; pass exactly one (ckpt: a converted param tree, "
            "checkpoint_path: the reference's release directory)")
    model.to_empty(device=device)
    init_random_weights(model, _seeded(device, int(cfg.get("seed", 0))))
    if ckpt:
        log.info("loading params from %s", ckpt)
        model.load_state_dict(state_dict_from_safetensors(ckpt), strict=True)
    elif ref_dir:
        log.info("porting reference checkpoint dir %s", ref_dir)
        vae_ckpt = cfg.get("vae_ckpt")
        state = port_onedc_checkpoint(
            unet_path=os.path.join(ref_dir, "model.safetensors"),
            codec_path=os.path.join(ref_dir, "model_1.safetensors"),
            vae_path=vae_ckpt, reference=model.state_dict(),
            require_complete=("unet", "codec"))
        model.load_state_dict(state, strict=True)
        if not vae_ckpt:
            log.warning("checkpoint_path has no VAE weights (the reference "
                        "downloads them from model_id); pass vae_ckpt= for "
                        "a fully ported model - the VAE is RANDOM INIT now")
    else:
        log.warning("no ckpt given: RANDOM INIT (smoke mode)")
    return model


def build_runtime(cfg: Mapping):
    """The config's runtime: (OneDCRuntime, load seconds). The model's
    weights from ``load_params``, a TinyVAE from ``tiny_vae_ckpt`` (or
    seeded random) under ``vae=tiny``, bf16 unless ``use_bf16`` is false,
    on the card unless ``device`` names another; ``quant=w8a8`` decodes in
    the w8a8 serving mode (``nn/quant.py``)."""
    quant = cfg.get("quant")
    if quant not in (None, "w8a8"):
        raise ValueError(f"unknown quant mode {quant!r}")
    device = resolve_device(cfg.get("device"))
    t0 = time.perf_counter()
    model = load_params(build_model(cfg), cfg, device)
    load_s = time.perf_counter() - t0
    log.info("weights loaded in %.2f s", load_s)
    vae_mode = cfg.get("vae")
    if vae_mode == "tiny":
        tiny_ckpt = cfg.get("tiny_vae_ckpt")
        if tiny_ckpt:
            tiny = TinyVaeDecoder(model.tiny_vae_ch, latent_ch=model.vae_ch)
            tiny.load_state_dict(state_dict_from_safetensors(tiny_ckpt),
                                 strict=True)
            model.vae_tiny_dec = tiny.to(device)
        else:
            log.warning("vae=tiny without tiny_vae_ckpt=: the TinyVAE "
                        "decoder is RANDOM INIT (smoke mode)")
            ensure_tiny_vae_params(model,
                                   _seeded(device, int(cfg.get("seed", 0))))
    dtype = torch.bfloat16 if cfg.get("use_bf16", True) else None
    return OneDCRuntime(model, dtype=dtype, device=device, vae=vae_mode,
                        quant=quant), load_s


class Evaluator:
    def __init__(self, cfg: Mapping):
        self.cfg = cfg
        self.runtime, self.load_s = build_runtime(cfg)
        self.model = self.runtime.model
        self.out_dir = Path(cfg.get("output_path", "outputs/inference"))
        (self.out_dir / "bin").mkdir(parents=True, exist_ok=True)
        (self.out_dir / "recon").mkdir(parents=True, exist_ok=True)

    def _load_captions(self) -> Dict[str, str]:
        """Optional ``captions_file`` (JSON {image stem: caption}): the
        caption rides the bitstream container."""
        path = self.cfg.get("captions_file")
        if not path:
            return {}
        with open(path) as f:
            return json.load(f)

    def _dataset(self) -> ImageFolderDataset:
        ds = ImageFolderDataset(self.cfg["dataset_path"])
        if not len(ds):
            raise ValueError(f"no images under {self.cfg['dataset_path']}")
        return ds

    def _save_recon(self, recon: torch.Tensor, name: str) -> None:
        save_image(recon[0].cpu().numpy(),
                   self.out_dir / "recon" / f"{name}.png")

    def _synchronize(self) -> None:
        if self.runtime.device.type == "cuda":
            torch.cuda.synchronize(self.runtime.device)

    def evaluate(self) -> Dict[str, float]:
        """Each image alone: encode to ``bin/<name>.bin``, decode that
        file, write ``recon/<name>.png``; per-image encode and decode
        seconds in the reports."""
        ds = self._dataset()
        captions = self._load_captions()
        rows: List[Dict] = []
        avg = AvgDict()
        for i in range(len(ds)):
            item = ds[i]
            name = item["name"]
            bin_path = self.out_dir / "bin" / f"{name}.bin"
            caption = captions.get(name, item["caption"])

            t0 = time.perf_counter()
            _, bpp = self.runtime.encode(item["image"][None], fp=str(bin_path),
                                         caption=caption)
            t_enc = time.perf_counter() - t0

            t0 = time.perf_counter()
            recon = self.runtime.decode(read_from_file(bin_path))
            self._synchronize()
            t_dec = time.perf_counter() - t0

            self._save_recon(recon, name)
            row = {"name": name, **bpp, "enc_s": t_enc, "dec_s": t_dec}
            rows.append(row)
            avg.update({k: v for k, v in row.items() if k != "name"})
            log.info("%s bpp=%.4f (y=%.4f z=%.4f) enc=%.2fs dec=%.2fs",
                     name, bpp["bpp"], bpp["bpp_y"], bpp["bpp_z"], t_enc,
                     t_dec)
        self._write_reports(rows, avg.mean())
        return avg.mean()

    def evaluate_batched(self) -> Dict[str, float]:
        """``--serving``: every image through ``encode_many`` and every
        stream through ``decode_batch``, with the aggregate encodes/s and
        decodes/s in the summary in place of the per-image seconds."""
        ds = self._dataset()
        captions = self._load_captions()
        items = [ds[i] for i in range(len(ds))]
        caps = [captions.get(it["name"], it["caption"]) for it in items]

        t0 = time.perf_counter()
        enc = self.runtime.encode_many([it["image"][None] for it in items],
                                       captions=caps)
        t_enc = time.perf_counter() - t0
        streams = []
        for it, (stream, _) in zip(items, enc):
            write_to_file(stream, self.out_dir / "bin" / f"{it['name']}.bin")
            streams.append(stream)

        t0 = time.perf_counter()
        recons = self.runtime.decode_batch(streams)
        self._synchronize()
        t_dec = time.perf_counter() - t0

        rows: List[Dict] = []
        avg = AvgDict()
        for it, (_, bpp), recon in zip(items, enc, recons):
            self._save_recon(recon, it["name"])
            row = {"name": it["name"], **bpp}
            rows.append(row)
            avg.update({k: v for k, v in row.items() if k != "name"})
        summary = avg.mean()
        summary["encodes_per_sec"] = len(items) / t_enc
        summary["decodes_per_sec"] = len(items) / t_dec
        log.info("serving: %.2f encodes/s, %.2f decodes/s over %d images",
                 summary["encodes_per_sec"], summary["decodes_per_sec"],
                 len(items))
        self._write_reports(rows, summary)
        return summary

    def decode_only(self, bin_path) -> None:
        """Decode a ``.bin`` file, or every ``.bin`` in a folder, to
        ``recon/<stem>.png`` with no encoder state."""
        bin_path = Path(bin_path)
        bins = ([bin_path] if bin_path.is_file()
                else sorted(bin_path.glob("*.bin")))
        for b in bins:
            self._save_recon(self.runtime.decode(read_from_file(b)), b.stem)
            log.info("decoded %s -> %s", b.name,
                     self.out_dir / "recon" / f"{b.stem}.png")

    def _write_reports(self, rows: List[Dict], summary: Dict[str, float]):
        columns: List[str] = []  # pandas' order: first appearance
        for row in rows:
            columns += [k for k in row if k not in columns]
        for name, table, cols in (("bpp_detail.csv", rows, columns),
                                  ("bpp_summary.csv", [summary],
                                   list(summary))):
            with open(self.out_dir / name, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=cols)
                writer.writeheader()
                writer.writerows(table)
        log.info("summary: %s", {k: round(v, 5) for k, v in summary.items()})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default=None)
    parser.add_argument("--decoder_only", action="store_true")
    parser.add_argument("--decoder_bin_path", default=None)
    parser.add_argument("--serving", action="store_true",
                        help="batched serving paths (encode_many + "
                             "decode_batch) with aggregate throughput "
                             "instead of per-image timing")
    args, overrides = parser.parse_known_args(argv)
    cfg = load_config(args.config, overrides)

    ev = Evaluator(cfg)
    if args.decoder_only:
        if not args.decoder_bin_path:
            parser.error("--decoder_only needs --decoder_bin_path")
        ev.decode_only(args.decoder_bin_path)
    elif args.serving or cfg.get("serving"):
        ev.evaluate_batched()
    else:
        ev.evaluate()
    return ev


if __name__ == "__main__":
    main()
