"""The port stands alone: importing it (or chip_smoke.py) loads neither
jax, flax, optax nor onedc_tpu, nor the safetensors, PIL and pandas packages
that the card's machine lacks (PIL only inside the functions that read
other formats than PNG); its entry points need the card unless told
otherwise."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "onedc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "onedc_tpu")
# not at module level: the card's machine has none of them
ABSENT_ON_THE_CARD = ("safetensors", "PIL", "pandas")
REACHED_MODULES = ("onedc_tpu_torch.entropy.bound", "onedc_tpu_torch.config",
                    "onedc_tpu_torch.data.crops",
                    "onedc_tpu_torch.train.losses",
                    "onedc_tpu_torch.train.step",
                    "onedc_tpu_torch.train.trainer",
                    "onedc_tpu_torch.data.images",
                    "onedc_tpu_torch.eval.inference",
                    "onedc_tpu_torch.utils.logging",
                    "onedc_tpu_torch.utils.port_torch",
                    "onedc_tpu_torch.utils.safetensors",
                    "onedc_tpu_torch.serving.pipeline",
                    "onedc_tpu_torch.serving.bundle",
                    "onedc_tpu_torch.serving.decoder",
                    "onedc_tpu_torch.serving.encoder",
                    "onedc_tpu_torch.utils.aot",
                    "onedc_tpu_torch.utils.calibrate",
                    "onedc_tpu_torch.utils.device",
                    "onedc_tpu_torch.nn.quant",
                    "onedc_tpu_torch.ops.w8a8",
                    "onedc_tpu_torch.eval.metrics",
                    "onedc_tpu_torch.eval.quality",
                    "onedc_tpu_torch.eval.rd_sweep",
                    "onedc_tpu_torch.nn.lpips",
                    "onedc_tpu_torch.nn.dists",
                    "onedc_tpu_torch.nn.inception",
                    "onedc_tpu_torch.utils.convert_weights",
                    "onedc_tpu_torch.data.datasets",
                    "onedc_tpu_torch.parallel.tiled",
                    "onedc_tpu_torch.train.ema",
                    "onedc_tpu_torch.utils.checkpoint",
                    "onedc_tpu_torch.utils.preempt",
                    "onedc_tpu_torch.nn.swin",
                    "onedc_tpu_torch.nn.vqgan",
                    "onedc_tpu_torch.models.codeformer",
                    "onedc_tpu_torch.utils.remat",
                    "onedc_tpu_torch.models.dmd",
                    "onedc_tpu_torch.nn.text_encoder",
                    "onedc_tpu_torch.train.trainer_stage2",
                    "onedc_tpu_torch.parallel.distributed",
                    "onedc_tpu_torch.parallel.mesh",
                    "onedc_tpu_torch.parallel.fsdp",
                    "onedc_tpu_torch.parallel.spatial")


def test_import_loads_no_jax_and_no_onedc_tpu():
    code = (
        "import pkgutil, sys\n"
        "import onedc_tpu_torch\n"
        "for m in pkgutil.walk_packages(onedc_tpu_torch.__path__,"
        " 'onedc_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ABSENT_ON_THE_CARD!r})\n"
        f"missing = [m for m in {REACHED_MODULES!r} if m not in "
        "sys.modules]\n"
        "print(len([m for m in sys.modules if m.startswith("
        "'onedc_tpu_torch.')]), missing, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, rest = out.stdout.split(" ", 1)
    assert int(n_modules) >= 70
    # the walk reached every training, quality, tiling, distillation,
    # stage-II and multi-process module
    assert rest.strip() == "[] []"


def test_source_imports_nothing_of_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|onedc_tpu)(\.|\s|$)",
        re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    top_level = re.compile(
        r"^(from|import)\s+(safetensors|PIL|pandas)(\.|\s|$)", re.M)
    offenders = [str(f) for f in files if pattern.search(f.read_text())
                 or top_level.search(f.read_text())]
    assert offenders == []


def test_runtime_needs_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from __graft_entry__ import _tiny_cfg
    from onedc_tpu_torch.models.onedc import OneDC, OneDCRuntime
    model = OneDC(**_tiny_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OneDCRuntime(model)
    assert OneDCRuntime(model, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("entry", ["quality", "rd_sweep"])
def test_quality_entry_points_need_the_card_unless_told_otherwise(
        entry, tmp_path):
    """``eval.quality.main`` and ``eval.rd_sweep.main`` (through the
    metric nets' and the Evaluator's device) raise without a GPU unless
    given ``--device cpu`` / ``device=cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from onedc_tpu_torch.eval import quality, rd_sweep
    if entry == "quality":
        argv = ["--real_dir", str(tmp_path), "--fake_dir", str(tmp_path)]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quality.main(argv)
        with pytest.raises(ValueError, match="no paired images"):
            quality.main(argv + ["--device", "cpu"])
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rd_sweep.main(["--config", str(ROOT / "configs" /
                                           "rd_sweep.yaml")])


def test_trainer_needs_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from __graft_entry__ import _tiny_cfg
    from onedc_tpu_torch.train.trainer import Trainer
    cfg = {"allow_no_lpips": True, "model": _tiny_cfg(),
           "run_dir": str(tmp_path / "run")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    assert Trainer(cfg, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("entry", ["stage2_trainer", "text_encoder"])
def test_stage2_entry_points_need_the_card_unless_told_otherwise(entry):
    """``Stage2Trainer`` and ``TextEncoder`` raise without a GPU unless given
    a device, before building any weights."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from onedc_tpu_torch.nn.text_encoder import TextEncoder
    from onedc_tpu_torch.train.trainer_stage2 import Stage2Trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "text_encoder":
            TextEncoder()
        else:
            Stage2Trainer({"allow_no_lpips": True})
    if entry == "text_encoder":
        enc = TextEncoder(device="cpu", config=dict(
            hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=4))
        assert enc.encode(enc.tokenize([""])).shape == (1, 77, 32)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
