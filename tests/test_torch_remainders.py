"""The port's last modules against the JAX package, on the CPU at the tiny
width: the TinyVAE encoder, ``convert_weights onedc`` and the CLI's
``ckpt=`` of its file, ``Config`` / ``instantiate``, the writers (read back
with TensorBoard's event reader) and ``profile_trace``,
``CommonCanvasDataset`` and ``fetch_common_canvas`` on a small HF dataset
on disk. No JAX compile of a model."""

import json
import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onedc_tpu import config as jconfig
from onedc_tpu.data import datasets as jdata
from onedc_tpu.nn import vae as jvae
from onedc_tpu.utils import convert_weights as jconvert
from onedc_tpu.utils import logging as jlogging
from onedc_tpu_torch import config as pconfig
from onedc_tpu_torch.data import datasets as pdata
from onedc_tpu_torch.data import fetch as pfetch
from onedc_tpu_torch.eval import inference
from onedc_tpu_torch.nn.vae import TinyVaeDecoder, TinyVaeEncoder
from onedc_tpu_torch.utils import convert_weights as pconvert
from onedc_tpu_torch.utils import logging as plogging
from onedc_tpu_torch.utils.convert import state_dict_from_jax
from onedc_tpu_torch.utils.safetensors import load_safetensors, \
    save_safetensors
from test_torch_port_checkpoint import TINY_MODEL, tiny_twins
from torch_port_common import (  # noqa: F401  (a fixture)
    fill_params,
    one_torch_thread,
    tiny_jax_model,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ENCODER_REL = 1e-5


# -- the TinyVAE encoder -----------------------------------------------------

def test_tiny_vae_encoder_matches_jax():
    """Seeded flax weights carried across by ``state_dict_from_jax``; the
    latents within 1e-5 of JAX's largest, in f32; the port's encoder then
    the decoder round trip gives an image of the input's size."""
    enc = jvae.TinyVaeEncoder(ch=16, latent_ch=4)
    x = np.random.default_rng(20).uniform(-1, 1, (2, 64, 48, 3))
    x = x.astype(np.float32)
    shapes = jax.eval_shape(lambda: enc.init(jax.random.PRNGKey(0),
                                             jnp.asarray(x)))
    params = fill_params(shapes, np.random.default_rng(21))
    want = np.asarray(enc.apply(params, jnp.asarray(x)))
    port = TinyVaeEncoder(ch=16, latent_ch=4)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert got.shape == (2, 4, 8, 6)
        got = got.permute(0, 2, 3, 1).numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= ENCODER_REL, err
        image = TinyVaeDecoder(ch=16, latent_ch=4)(torch.from_numpy(got)
                                                   .permute(0, 3, 1, 2))
    assert image.shape == (2, 3, 64, 48) and torch.isfinite(image).all()
    # no bias on the stride-2 convs, as JAX's use_bias=False
    assert all(getattr(port, f"stage{i}_down").bias is None for i in range(3))


# -- convert_weights onedc ---------------------------------------------------

def _model_overrides():
    return [f"model.{k}={json.dumps(list(v) if isinstance(v, tuple) else v)}"
            for k, v in TINY_MODEL.items()]


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """The tiny twins release: model.safetensors (UNet + LoRA),
    model_1.safetensors (codec) and a diffusers VAE file."""
    root = tmp_path_factory.mktemp("release")
    for name, sd in zip(("model", "model_1", "vae"), tiny_twins()):
        save_safetensors(sd, root / f"{name}.safetensors")
    return root


def test_convert_onedc_equals_jax_file(release, tmp_path, monkeypatch):
    """``convert_weights onedc`` of the twins with ``--vae`` (every tensor
    filled) against JAX's ``convert_onedc`` of the same files: the same
    keys, dtypes and tensors bit for bit. JAX's flax init (which only gives
    the shapes here) is replaced by the seeded tree of the same shapes."""
    args = ["onedc", "--unet", str(release / "model.safetensors"),
            "--codec", str(release / "model_1.safetensors"),
            "--vae", str(release / "vae.safetensors")]
    pconvert.main(args + ["--out", str(tmp_path / "port.safetensors")]
                  + _model_overrides())
    params = tiny_jax_model()[1]
    monkeypatch.setattr(jax, "jit", lambda fn: (lambda *a: params))
    jconvert.main(args + ["--out", str(tmp_path / "jax.safetensors")]
                  + _model_overrides())
    monkeypatch.undo()
    got = load_safetensors(tmp_path / "port.safetensors")
    want = load_safetensors(tmp_path / "jax.safetensors")
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k].dtype != want[k].dtype
            or not torch.equal(got[k], want[k])] == []


@pytest.mark.parametrize("vae", [True, False])
def test_ckpt_of_the_converted_file_equals_checkpoint_path(release, tmp_path,
                                                           vae):
    """The CLI's ``ckpt=`` of the converted file loads the model that
    ``checkpoint_path=`` (with ``vae_ckpt=``, or without: the VAE the
    seeded random one on both sides) loads, bit for bit; with the VAE, both
    runtimes decode one stream to the same image."""
    out = tmp_path / "onedc.safetensors"
    extra = ["--vae", str(release / "vae.safetensors")] if vae else []
    pconvert.main(["onedc", "--unet", str(release / "model.safetensors"),
                   "--codec", str(release / "model_1.safetensors"),
                   "--out", str(out)] + extra + _model_overrides()
                  + ["device=cpu"])
    base = {"model": dict(TINY_MODEL), "device": "cpu", "use_bf16": False}
    ported = dict(base, checkpoint_path=str(release))
    if vae:
        ported["vae_ckpt"] = str(release / "vae.safetensors")
    models = [inference.load_params(inference.build_model(c), c,
                                    torch.device("cpu"))
              for c in (dict(base, ckpt=str(out)), ported)]
    a, b = (m.state_dict() for m in models)
    assert sorted(a) == sorted(b)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    if vae:
        rts = [inference.build_runtime(c)[0]
               for c in (dict(base, ckpt=str(out)), ported)]
        image = np.random.default_rng(22).uniform(-1, 1, (1, 64, 64, 3))
        stream, _ = rts[0].encode(image.astype(np.float32))
        assert torch.equal(rts[0].decode(stream), rts[1].decode(stream))


def test_convert_onedc_rejects_unknown_arguments(release, tmp_path):
    with pytest.raises(SystemExit):
        pconvert.main(["lpips", "--vgg", "a", "--lins", "b", "--out",
                       str(tmp_path / "x"), "model.internal_ch=64"])


# -- Config / instantiate ----------------------------------------------------

def test_config_behaves_as_jax(tmp_path: pathlib.Path):
    """``tests/test_config.py``'s cases on the port's ``Config``, with a
    port target for ``instantiate``."""
    p = tmp_path / "c.yaml"
    p.write_text("a: 1\nnested:\n  x: 2\n  y: [1, 2]\nname: foo\n")
    args = ["nested.x=5", "new.key=hello", "a=2.5"]
    cfg = pconfig.Config.wrap(pconfig.load_config(str(p), args))
    assert cfg.to_dict() == jconfig.load_config(str(p), args).to_dict()
    assert cfg.a == 2.5 and cfg.nested.x == 5 and cfg.nested.y == [1, 2]
    assert cfg.new.key == "hello" and cfg.name == "foo"
    with pytest.raises(AttributeError):
        cfg.missing
    cfg.set_path("deep.er.z", {"w": [{"v": 1}]})
    assert cfg.deep.er.z.w[0].v == 1
    assert cfg.get_path("deep.er.z.w") == [{"v": 1}]
    assert cfg.get_path("nested.q", 7) == 7 and cfg.get_path("a.b") is None
    cfg.extra = 3
    assert cfg["extra"] == 3
    out = pconfig.merge(pconfig.Config.wrap({"a": {"b": 1, "c": 2}}),
                        {"a": {"b": 9}})
    assert pconfig.Config.wrap(out).a.b == 9 and out["a"]["c"] == 2
    assert type(pconfig.Config.wrap({"a": {}}).to_dict()["a"]) is dict

    obj = pconfig.instantiate({"target": "collections.OrderedDict",
                               "params": {}})
    assert type(obj).__name__ == "OrderedDict"
    enc = pconfig.instantiate(
        {"target": "onedc_tpu_torch.nn.vae.TinyVaeEncoder",
         "params": {"ch": 8}}, latent_ch=2)
    assert isinstance(enc, TinyVaeEncoder) and enc.conv_out.out_channels == 2
    assert pconfig.instantiate({"target": "onedc_tpu_torch.entropy."
                                "huffman.HuffmanCodec", "params": None})


# -- writers and the profiler trace ------------------------------------------

def _write(writer):
    writer.log_config({"lr": 1e-4, "model": {"ch": 8}})
    writer.log_dict({"loss": 0.5, "bpp": 0.125}, 3, prefix="train")
    writer.log_dict({"plain": 2.0}, 4)
    writer.log_image("eval/recon", np.full((8, 6, 3), -0.5, np.float32), 4)
    writer.log_image("eval/gt", np.full((8, 6, 3), 0.25, np.float32), 4)
    writer.flush()


def _events(log_dir):
    """Scalars, images and texts of the event files in ``log_dir``, read by
    tensorboard's ``EventAccumulator`` on its own file layer (the
    ``notf`` switch of ``tensorboard.compat``: its reader would otherwise
    import TensorFlow wherever that is installed)."""
    import sys
    import types

    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(str(log_dir), size_guidance={"images": 0,
                                                        "tensors": 0})
    acc.Reload()
    tags = acc.Tags()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)]
               for t in tags["scalars"]}
    images = {t: [(e.step, e.width, e.height,
                   _png_pixels(e.encoded_image_string).tolist())
                  for e in acc.Images(t)] for t in tags["images"]}
    texts = {t: [(e.step, e.tensor_proto.string_val[0].decode())
                 for e in acc.Tensors(t)] for t in tags["tensors"]}
    return scalars, images, texts


def _png_pixels(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


WRITER_EVENTS = pathlib.Path(__file__).parent / "torch_golden" / \
    "writer_events.json"


def jax_writer_events(tmp_path) -> dict:
    """What JAX's ``TensorboardWriter`` writes for ``_write``'s calls, as
    ``_events`` reads it (JSON-ready)."""
    jw = jlogging.TensorboardWriter(tmp_path)
    _write(jw)
    jw.close()
    return json.loads(json.dumps(_events(tmp_path)))


def test_writers_write_the_tags_jax_writes(tmp_path):
    """The port's ``make_writer`` on process 0: ``metrics.jsonl`` and the
    PNGs as before, and TensorBoard events under ``tb`` with the tags,
    steps, values, image pixels and config text that JAX's
    ``TensorboardWriter`` writes given the same calls (stored in
    ``torch_golden/writer_events.json``: importing JAX's writer,
    ``torch.utils.tensorboard``, imports TensorFlow where it is installed,
    10-16 s; ``test_stored_writer_events_are_jax_events`` writes them
    again; the PNG bytes differ, PIL encodes JAX's)."""
    pytest.importorskip("tensorboard")
    writer = plogging.make_writer(tmp_path / "port")
    assert isinstance(writer, plogging.MultiWriter)
    _write(writer)
    writer.close()
    got = json.loads(json.dumps(_events(tmp_path / "port" / "tb")))
    assert got == json.loads(WRITER_EVENTS.read_text())
    assert sorted(got[0]) == ["plain", "train/bpp", "train/loss"]
    assert sorted(got[1]) == ["eval/gt", "eval/recon"]
    assert list(got[2]) == ["config/text_summary"]
    rows = plogging.read_metrics(tmp_path / "port")
    assert rows == [{"step": 3, "train/loss": 0.5, "train/bpp": 0.125},
                    {"step": 4, "plain": 2.0}]
    assert sorted(p.name for p in (tmp_path / "port" / "images").iterdir()) \
        == ["eval_gt_000004.png", "eval_recon_000004.png"]


@pytest.mark.slow
def test_stored_writer_events_are_jax_events(tmp_path):
    assert jax_writer_events(tmp_path) == json.loads(
        WRITER_EVENTS.read_text())


def test_writer_sinks_that_cannot_open_warn(tmp_path, monkeypatch, caplog):
    """No tensorboard: the files alone, one warning; a wandb project with
    no wandb package (or no network): one warning, as JAX's make_writer;
    not process 0 (``enabled=False``): the null writer, JAX's
    ``NoOpWriter``."""
    def no_tensorboard(log_dir):
        raise ImportError("No module named 'tensorboard'")
    monkeypatch.setattr(plogging, "TensorboardWriter", no_tensorboard)
    monkeypatch.setitem(__import__("sys").modules, "wandb", None)
    w = plogging.make_writer(tmp_path / "a", wandb_project="p")
    assert isinstance(w, plogging.RunWriter)
    warnings = [r.getMessage() for r in caplog.records
                if r.levelno == logging.WARNING]
    assert len(warnings) == 2
    assert "tensorboard unavailable" in warnings[0]
    assert "wandb unavailable" in warnings[1]
    w.log_dict({"x": 1.0}, 1)
    w.close()
    assert plogging.read_metrics(tmp_path / "a") == [{"step": 1, "x": 1.0}]
    null = plogging.make_writer(tmp_path / "b", enabled=False)
    assert isinstance(null, plogging.NoOpWriter)
    assert plogging.NoOpWriter is plogging.NullWriter
    null.log_dict({"x": 1.0}, 1)
    null.close()
    assert not (tmp_path / "b").exists()


def test_profile_trace_writes_a_trace_naming_an_aten_op(tmp_path):
    a = torch.randn(64, 64)
    with plogging.profile_trace(tmp_path / "trace") as prof:
        torch.mm(a, a)
    assert prof is not None
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "aten::mm" in names
    with plogging.profile_trace(tmp_path / "off", enabled=False) as prof:
        torch.mm(a, a)
    assert prof is None and not (tmp_path / "off").exists()


# -- CommonCanvas ------------------------------------------------------------

@pytest.fixture(scope="module")
def canvas(tmp_path_factory):
    """A 3-row HF dataset with CommonCanvas' columns (``jpg`` images of
    different sizes, one grey, ``blip2_caption``), saved to disk."""
    datasets = pytest.importorskip("datasets")
    from PIL import Image

    rng = np.random.default_rng(23)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
              for h, w in ((16, 24), (20, 12))]
    images.append(Image.fromarray(rng.integers(0, 256, (8, 8), np.uint8)))
    ds = datasets.Dataset.from_dict(
        {"jpg": images, "blip2_caption": ["a cat", "", "grey"]},
        features=datasets.Features({"jpg": datasets.Image(),
                                    "blip2_caption": datasets.Value(
                                        "string")}))
    root = tmp_path_factory.mktemp("canvas")
    ds.save_to_disk(str(root / "cc"))
    return ds, root / "cc"


def _same_rows(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert (g["caption"], g["name"]) == (w["caption"], w["name"])
        assert g["image"].dtype == np.float32
        np.testing.assert_array_equal(g["image"], w["image"])


@pytest.mark.parametrize("loading_length", [None, 2])
def test_common_canvas_rows_equal_jax(canvas, loading_length):
    _, path = canvas
    got = pdata.CommonCanvasDataset(path, loading_length=loading_length)
    want = jdata.CommonCanvasDataset(path, loading_length=loading_length)
    assert len(got) == (3 if loading_length is None else 2)
    _same_rows(got, want)
    assert got[2 if loading_length is None else 1]["image"].shape[-1] == 3


def test_fetch_common_canvas_saves_what_it_loads(canvas, tmp_path,
                                                 monkeypatch):
    import datasets

    ds, path = canvas
    calls = []

    def load_dataset(name, split):
        calls.append((name, split))
        return ds
    monkeypatch.setattr(datasets, "load_dataset", load_dataset)
    pfetch.main(["--out_dir", str(tmp_path / "cc")])
    out = pfetch.fetch_common_canvas(str(tmp_path / "cc2"), "n", "s")
    assert out == str(tmp_path / "cc2")
    assert calls == [("common-canvas/commoncatalog-cc-by-nd", "train"),
                     ("n", "s")]
    _same_rows(pdata.CommonCanvasDataset(tmp_path / "cc"),
               jdata.CommonCanvasDataset(path))
