"""The port's quality harness (``onedc_tpu_torch/eval/quality.py``) against
the JAX package's on the same folders and weight files, on the CPU; the
port's RD sweep (``eval/rd_sweep.py``) on the tiny model, as
``tests/test_rd_sweep.py`` runs the JAX one; the weight converter CLI
(``utils/convert_weights.py``) against the JAX package's."""

import csv
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_common import TINY, one_torch_thread  # noqa: F401

from onedc_tpu.eval import quality as jquality
from onedc_tpu.nn.dists import make_dists_fn as jax_dists_fn
from onedc_tpu.nn.lpips import make_lpips_fn as jax_lpips_fn
from onedc_tpu.utils import convert_weights as jcw
from onedc_tpu.utils.checkpoint import flatten_params
from onedc_tpu.utils.checkpoint import load_safetensors as jax_load
from onedc_tpu_torch.data.images import save_image
from onedc_tpu_torch.eval import quality, rd_sweep
from onedc_tpu_torch.nn import dists, inception, lpips
from onedc_tpu_torch.utils import convert_weights as pcw
from onedc_tpu_torch.utils.safetensors import load_safetensors as port_load
from onedc_tpu_torch.utils.safetensors import save_safetensors

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = Path(__file__).resolve().parents[1]

# per-image PSNR in dB; MS-SSIM, LPIPS and DISTS in f32 (the frameworks'
# convolutions sum in other orders)
PSNR_TOL = 1e-4
ATOL, RTOL = 1e-5, 1e-4


def _csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """real/ and fake/ PNG folders: a 176x184 pair (MS-SSIM's smallest
    side), a 96x128 pair (no MS-SSIM) and one unpaired image; the LPIPS
    and DISTS weight files."""
    tmp = tmp_path_factory.mktemp("quality")
    rng = np.random.default_rng(0)
    (tmp / "real").mkdir()
    (tmp / "fake").mkdir()
    for name, (h, w) in (("a", (176, 184)), ("b", (96, 128))):
        img = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
        save_image(img, tmp / "real" / f"{name}.png")
        save_image(np.clip(img + 0.2 * rng.standard_normal(img.shape), -1,
                           1).astype(np.float32), tmp / "fake" / f"{name}.png")
    save_image(np.zeros((8, 8, 3), np.float32), tmp / "real" / "c.png")
    save_safetensors(lpips.random_lpips_weights(0), tmp / "lpips")
    save_safetensors(dists.random_dists_weights(1), tmp / "dists")
    return tmp


def _features(patches):
    """A numpy feature extractor shared by both harnesses: a fixed random
    projection of patch statistics (the networks are held in
    ``test_torch_metric_nets.py``)."""
    p = np.asarray(patches, np.float64) / 255.0
    v = np.concatenate([p.mean((1, 2)), p.std((1, 2)),
                        p[:, ::16, ::16, 0].reshape(len(p), -1)], 1)
    proj = np.random.default_rng(1).standard_normal((v.shape[1], 8))
    f = np.tanh(v @ proj)
    return {"features": f.astype(np.float32),
            "logits": (3 * f[:, :5]).astype(np.float32)}


def test_two_folders_matches_the_jax_package(folders, tmp_path, caplog):
    """Per-image rows and the summary, with LPIPS, DISTS and the patch
    statistics (patch 48), against the JAX harness's on the same files
    (its ``out_csv=None``); the port's CSV columns are the JAX rows' keys
    in order, its ``_summary`` file the JAX summary's."""
    ref_summary, ref_rows = jquality.test_two_folders(
        folders / "real", folders / "fake", out_csv=None,
        lpips_fn=jax_lpips_fn(folders / "lpips"),
        dists_fn=jax_dists_fn(folders / "dists"), feature_fn=_features,
        patch=48)
    with caplog.at_level(logging.WARNING):
        summary, rows = quality.test_two_folders(
            folders / "real", folders / "fake", out_csv=tmp_path / "q.csv",
            lpips_fn=lpips.make_lpips_fn(folders / "lpips", device="cpu"),
            dists_fn=dists.make_dists_fn(folders / "dists", device="cpu"),
            feature_fn=_features, patch=48, device="cpu")
    assert "unpaired images skipped: ['c']" in caplog.text
    assert [list(r) for r in rows] == [list(r) for r in ref_rows]
    assert [r["name"] for r in rows] == ["a", "b"] and "ms_ssim" not in rows[1]
    for got, ref in zip(rows, ref_rows):
        assert abs(got["psnr"] - ref["psnr"]) <= PSNR_TOL
        for k in set(ref) - {"name", "psnr"}:
            np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    assert list(summary) == list(ref_summary)
    for k in ("patch_fid", "patch_kid", "patch_kid_std", "inception_mean",
              "inception_std"):
        assert summary[k] == ref_summary[k], k
    for k in ("ms_ssim", "lpips", "dists"):
        np.testing.assert_allclose(summary[k], ref_summary[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)

    header, body = _csv(tmp_path / "q.csv")
    assert header == list(ref_rows[0]) and len(body) == 2
    assert body[1][header.index("ms_ssim")] == ""
    assert float(body[0][header.index("lpips")]) == rows[0]["lpips"]
    header, body = _csv(tmp_path / "q_summary.csv")
    assert header == list(ref_summary) and len(body) == 1


def test_quality_cli_writes_csv_for_an_xlsx_request(folders, tmp_path,
                                                   caplog):
    """``main`` with ``--device cpu`` and the LPIPS / DISTS files: a .xlsx
    request writes the CSV pair with the JAX package's warning, and FID
    is skipped with a warning without Inception weights."""
    with caplog.at_level(logging.WARNING):
        summary, rows = quality.main([
            "--real_dir", str(folders / "real"),
            "--fake_dir", str(folders / "fake"),
            "--out", str(tmp_path / "q.xlsx"), "--device", "cpu",
            "--lpips_weights", str(folders / "lpips"),
            "--dists_weights", str(folders / "dists")])
    assert "writing CSV instead" in caplog.text
    assert "FID/KID/IS skipped" in caplog.text
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "q.csv", "q_summary.csv"]
    header, body = _csv(tmp_path / "q_summary.csv")
    assert header == ["dists", "lpips", "ms_ssim", "psnr"]
    assert np.allclose([float(v) for v in body[0]],
                       [summary[k] for k in header])
    assert quality.test_two_folders.__test__ is False


def test_run_sweep_on_the_tiny_model(tmp_path, monkeypatch):
    """Two points (the lambda model and the z-only exlow one, a per-point
    override) through the port's Evaluator: rows, bpp order, exlow's y
    rate 0, finite metrics; the metric networks built once; rd_curve.csv
    rewritten after each point, sorted by bpp."""
    rng = np.random.default_rng(0)
    data = tmp_path / "imgs"
    data.mkdir()
    for i in range(2):
        save_image(rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32),
                   data / f"im{i}.png")
    weights = tmp_path / "lpips.safetensors"
    save_safetensors(lpips.random_lpips_weights(0), weights)
    built = []
    make = lpips.make_lpips_fn
    monkeypatch.setattr(lpips, "make_lpips_fn",
                        lambda *a, **k: built.append(a) or make(*a, **k))
    csv_path = tmp_path / "sweep" / "rd_curve.csv"
    seen = []
    run_point = rd_sweep.run_point

    def recording(cfg, point):
        seen.append(_csv(csv_path) if csv_path.exists() else None)
        return run_point(cfg, point)
    monkeypatch.setattr(rd_sweep, "run_point", recording)

    rows = rd_sweep.main([
        "--config", str(ROOT / "configs" / "rd_sweep.yaml"),
        f"dataset_path={data}",
        f"output_path={tmp_path / 'sweep'}", "device=cpu", "use_bf16=false",
        f"lpips_weights={weights}", "model=" + json.dumps(TINY),
        "points=[{name: lambda_point}, {name: exlow, model: {z_only: "
        "true}}]"])
    assert len(built) == 1 and len(rows) == 2
    by_name = {r["name"]: r for r in rows}
    assert by_name["exlow"]["bpp"] < by_name["lambda_point"]["bpp"]
    assert by_name["exlow"]["bpp_y"] == 0.0
    for r in rows:
        assert all(np.isfinite(r[k]) for k in ("psnr", "lpips", "bpp"))
    assert seen[0] is None
    header, body = seen[1]
    assert len(body) == 1 and body[0][header.index("name")] == "lambda_point"
    header, body = _csv(csv_path)
    assert header == list(rows[0])
    assert [b[header.index("name")] for b in body] == ["exlow",
                                                       "lambda_point"]


def test_convert_weights_cli_writes_the_jax_packages_files(tmp_path):
    """The three subcommands on torch files (``torch.save``) write what
    the JAX package's CLI writes from the same files, tensor for tensor;
    a subcommand neither package has is refused (``onedc``, which the
    port lacked, is ported: ``test_torch_remainders.py``)."""
    rng = np.random.default_rng(12)
    vgg = {k: torch.from_numpy(v)
           for k, v in lpips.random_vgg16_state(rng).items()}
    lins = {f"lin{k}.model.1.weight": torch.rand(1, c, 1, 1)
            for k, c in enumerate((64, 128, 256, 512, 512))}
    ab = {k: torch.rand(1, 1472, 1, 1) for k in ("alpha", "beta")}
    inc = {k: torch.from_numpy(v)
           for k, v in inception.random_torch_inception(4, 6).items()}
    for obj, name in ((vgg, "vgg"), (lins, "lins"), (ab, "dists"),
                      (inc, "inc")):
        torch.save(obj, tmp_path / f"{name}.pth")
    src = {n: str(tmp_path / f"{n}.pth") for n in ("vgg", "lins", "dists",
                                                   "inc")}
    for args in (["inception", "--src", src["inc"]],
                 ["dists", "--vgg", src["vgg"], "--dists", src["dists"]],
                 ["lpips", "--vgg", src["vgg"], "--lins", src["lins"]]):
        jcw.main(args + ["--out", str(tmp_path / "j.safetensors")])
        pcw.main(args + ["--out", str(tmp_path / "p.safetensors")])
        ref = flatten_params(jax_load(tmp_path / "j.safetensors"))
        got = port_load(tmp_path / "p.safetensors")
        assert sorted(ref) == sorted(got)
        for k in ref:
            assert np.array_equal(ref[k], got[k].numpy()), (args[0], k)
    with pytest.raises(SystemExit):
        pcw.main(["vqgan", "--out", str(tmp_path / "o.safetensors")])


def test_metric_nets_need_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    path = tmp_path / "lpips.safetensors"
    save_safetensors(lpips.random_lpips_weights(0), path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lpips.make_lpips_fn(path)
    assert next(lpips.load_lpips(path, device="cpu").parameters()).device == \
        torch.device("cpu")
