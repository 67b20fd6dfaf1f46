"""Quality harness: folder-vs-folder metric comparison.

JAX counterpart: ``onedc_tpu/eval/quality.py`` (``pair_folders`` :35,
``test_two_folders`` :47, ``_write_report`` :99, ``main``), the
reference's ``src/test_quality.py``: per image PSNR / MS-SSIM (where the
short side is at least 176) / LPIPS / DISTS, and patch-FID / KID /
Inception Score over the patches (the Mentzer FID/256 protocol), with a
per-image report and a ``_summary`` one.

LPIPS / DISTS / FID / IS need pretrained feature weights (VGG16 /
InceptionV3), converted safetensors on disk (``utils/convert_weights.py``):
``--lpips_weights`` / ``--dists_weights`` / ``--inception_weights``.
Metrics without weights are skipped with a warning; PSNR and MS-SSIM
always run. Reports are CSV, with the columns of the JAX package's
``DataFrame(rows)``; a ``.xlsx`` request writes CSV with the JAX
package's warning (the card's machine has no pandas and no xlsx engine).
The harness runs on the card unless ``--device`` names another.

Usage:
  python -m onedc_tpu_torch.eval.quality --real_dir A --fake_dir B \\
      --out out.csv [--lpips_weights L] [--dists_weights D] \\
      [--inception_weights I] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.images import IMG_EXTS, load_image
from ..utils.device import resolve_device
from ..utils.logging import get_logger, write_csv
from ..utils.numerics import pinned_numerics
from .metrics import compute_patch_fid, ms_ssim, psnr

log = get_logger("onedc_tpu_torch.quality")


def pair_folders(real_dir, fake_dir):
    real = {p.stem: p for p in Path(real_dir).iterdir()
            if p.suffix.lower() in IMG_EXTS}
    fake = {p.stem: p for p in Path(fake_dir).iterdir()
            if p.suffix.lower() in IMG_EXTS}
    names = sorted(set(real) & set(fake))
    missing = sorted(set(real) ^ set(fake))
    if missing:
        log.warning("unpaired images skipped: %s", missing[:10])
    return [(n, real[n], fake[n]) for n in names]


def test_two_folders(real_dir, fake_dir, out_csv=None,
                     lpips_fn=None, feature_fn=None, dists_fn=None,
                     patch: int = 256, device=None):
    """(summary, rows) of the paired images of two folders; ``lpips_fn``
    / ``dists_fn`` take (1, H, W, 3) tensors in [0, 1] on ``device`` (the
    card unless named), ``feature_fn`` uint8-range numpy patches."""
    device = resolve_device(device)
    pairs = pair_folders(real_dir, fake_dir)
    if not pairs:
        raise ValueError(f"no paired images in {real_dir} and {fake_dir}")

    rows = []
    for name, rp, fp in pairs:
        x = load_image(rp) * 0.5 + 0.5   # [0,1]
        y = load_image(fp) * 0.5 + 0.5
        if x.shape != y.shape:
            raise ValueError(f"{name}: {x.shape} vs {y.shape}")
        xb = torch.from_numpy(x)[None].to(device)
        yb = torch.from_numpy(y)[None].to(device)
        with torch.no_grad(), pinned_numerics():
            row = {"name": name, "psnr": float(psnr(xb, yb)[0])}
            if min(x.shape[0], x.shape[1]) >= 176:
                row["ms_ssim"] = float(ms_ssim(xb, yb)[0])
            if lpips_fn is not None:
                row["lpips"] = float(lpips_fn(xb, yb)[0])
            if dists_fn is not None:
                row["dists"] = float(dists_fn(xb, yb)[0])
        rows.append(row)
        log.info("%s %s", name,
                 {k: round(v, 4) for k, v in row.items() if k != "name"})

    summary = {}
    keys = set().union(*(set(r) for r in rows)) - {"name"}
    for k in sorted(keys):
        vals = [r[k] for r in rows if k in r]
        summary[k] = float(np.mean(vals))

    if feature_fn is not None:
        reals = (load_image(rp) for _, rp, _ in pairs)
        fakes = (load_image(fp) for _, _, fp in pairs)
        fid_res = compute_patch_fid(reals, fakes, feature_fn, patch)
        summary.update({"patch_fid": fid_res["fid"],
                        "patch_kid": fid_res["kid_mean"],
                        "patch_kid_std": fid_res["kid_std"]})
        if "inception_mean" in fid_res:
            summary["inception_mean"] = fid_res["inception_mean"]
            summary["inception_std"] = fid_res["inception_std"]
    else:
        log.warning("no feature extractor: FID/KID/IS skipped "
                    "(provide --inception_weights)")

    if out_csv:
        _write_report(rows, summary, out_csv)
    log.info("summary: %s", {k: round(v, 5) for k, v in summary.items()})
    return summary, rows


# a library function, not a test, wherever pytest finds it imported
test_two_folders.__test__ = False


def _write_report(rows, summary, out_path):
    """``out_path`` and its ``_summary`` file as CSV; a ``.xlsx`` (or any
    other) suffix gets ``.csv`` instead, as the JAX package does without
    an xlsx engine (test_quality.py:296-302 emits xlsx)."""
    out_path = Path(out_path)
    if out_path.suffix == ".xlsx":
        log.warning("no xlsx engine installed; writing CSV instead")
        out_path = out_path.with_suffix(".csv")
    if out_path.suffix != ".csv":
        out_path = out_path.with_suffix(out_path.suffix + ".csv")
    write_csv(out_path, rows)
    write_csv(out_path.with_name(out_path.stem + "_summary.csv"), [summary])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--real_dir", required=True)
    parser.add_argument("--fake_dir", required=True)
    parser.add_argument("--out", default="quality.csv",
                        help=".csv (a .xlsx request writes CSV)")
    parser.add_argument("--lpips_weights", default=None)
    parser.add_argument("--inception_weights", default=None,
                        help="converted InceptionV3 safetensors "
                             "(nn/inception.py:convert_torch_inception)")
    parser.add_argument("--dists_weights", default=None,
                        help="converted DISTS safetensors "
                             "(nn/dists.py:convert_torch_dists)")
    parser.add_argument("--patch", type=int, default=256)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    lpips_fn = None
    if args.lpips_weights:
        from ..nn.lpips import make_lpips_fn
        lpips_fn = make_lpips_fn(args.lpips_weights, device=device)
    feature_fn = None
    if args.inception_weights:
        from ..nn.inception import make_inception_fn
        feature_fn = make_inception_fn(args.inception_weights, device=device)
    dists_fn = None
    if args.dists_weights:
        from ..nn.dists import make_dists_fn
        dists_fn = make_dists_fn(args.dists_weights, device=device)
    return test_two_folders(args.real_dir, args.fake_dir, args.out,
                            lpips_fn=lpips_fn, feature_fn=feature_fn,
                            dists_fn=dists_fn, patch=args.patch,
                            device=device)


if __name__ == "__main__":
    main()
