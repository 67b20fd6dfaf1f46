"""RD sweep runner for the lambda checkpoint family.

JAX counterpart: ``onedc_tpu/eval/rd_sweep.py`` (``run_point`` :44,
``run_sweep`` :60, ``main``). The reference ships a family of checkpoints
(lambda 12.2 .. 0.6 + the z-only exlow point; readme.md:64,75) and
evaluates each with ``src/inference.py`` + ``src/test_quality.py`` by
hand; this runner does the whole rate-distortion curve in one command:

  python -m onedc_tpu_torch.eval.rd_sweep --config configs/rd_sweep.yaml \\
      [key.path=value ...]

Config shape (``configs/rd_sweep.yaml``, shared with the JAX package):

  dataset_path: /data/kodak
  output_path: outputs/rd_sweep
  model: {...}                  # shared OneDC config
  points:
    - {name: lmbda4.6, ckpt: /ckpts/onedc_lmbda4.6.safetensors}
    - {name: exlow, ckpt: /ckpts/exlow.safetensors,
       model: {z_only: true}}   # per-point overrides win
  lpips_weights: ...            # optional quality metric weights
  inception_weights: ...
  dists_weights: ...

Each point runs the port's inference CLI (``eval/inference.py:
Evaluator.evaluate``: encode -> ``.bin`` -> decode -> PNG) with the
point's keys merged over the config (``config.merge``); a point may name
``checkpoint_path`` (the reference's release directory) in place of
``ckpt``. The metric networks are built once. ``rd_curve.csv``: one row
per point, sorted by bpp, bpp + PSNR / MS-SSIM (+ LPIPS / DISTS /
patch-FID / KID / IS where weights are given), rewritten after every
point. Runs on the card unless the config says ``device: cpu``.
"""

from __future__ import annotations

import argparse
import gc
from pathlib import Path
from typing import List

from ..config import load_config, merge
from ..utils.logging import first_appearance, get_logger, write_csv
from .inference import Evaluator
from .quality import test_two_folders

log = get_logger("onedc_tpu_torch.rd_sweep")


def run_point(base_cfg: dict, point: dict) -> dict:
    """Encode/decode the dataset with one checkpoint; return summary."""
    cfg = merge(base_cfg, {k: v for k, v in point.items() if k != "name"})
    if "output_path" not in point:  # per-point override wins if given
        cfg["output_path"] = str(
            Path(base_cfg.get("output_path", "outputs/rd_sweep"))
            / point["name"])
    ev = Evaluator(cfg)
    summary = ev.evaluate()
    # the point's model is freed before the next point loads its own: the
    # runtime's objects can sit in reference cycles that only the
    # collector breaks (a sweep of full-width points held two at once)
    del ev
    gc.collect()
    summary["name"] = point["name"]
    summary["recon_dir"] = str(Path(cfg["output_path"]) / "recon")
    return summary


def run_sweep(cfg: dict) -> List[dict]:
    points = list(cfg.get("points") or [])
    if not points:
        raise ValueError("config needs a `points:` list")
    device = cfg.get("device")

    lpips_fn = feature_fn = dists_fn = None
    if cfg.get("lpips_weights"):
        from ..nn.lpips import make_lpips_fn
        lpips_fn = make_lpips_fn(cfg["lpips_weights"], device=device)
    if cfg.get("inception_weights"):
        from ..nn.inception import make_inception_fn
        feature_fn = make_inception_fn(cfg["inception_weights"],
                                       device=device)
    if cfg.get("dists_weights"):
        from ..nn.dists import make_dists_fn
        dists_fn = make_dists_fn(cfg["dists_weights"], device=device)

    out = Path(cfg.get("output_path", "outputs/rd_sweep"))
    out.mkdir(parents=True, exist_ok=True)
    csv_path = out / "rd_curve.csv"

    rows = []
    for point in points:
        log.info("=== RD point %s ===", point["name"])
        summary = run_point(cfg, dict(point))
        q, _ = test_two_folders(
            cfg["dataset_path"], summary.pop("recon_dir"),
            lpips_fn=lpips_fn, feature_fn=feature_fn, dists_fn=dists_fn,
            device=device)
        summary.update(q)
        rows.append(summary)
        # persist after EVERY point: a failing checkpoint later in the
        # sweep must not discard hours of completed points (the columns
        # in the order the points ran, as pandas sorts a frame)
        write_csv(csv_path, sorted(rows, key=lambda r: r["bpp"]),
                  columns=first_appearance(rows))
        log.info("point %s: bpp=%.4f psnr=%.2f (csv updated)",
                 point["name"], summary["bpp"],
                 summary.get("psnr", float("nan")))
    log.info("wrote %s", csv_path)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    args, overrides = parser.parse_known_args(argv)
    return run_sweep(load_config(args.config, overrides))


if __name__ == "__main__":
    main()
