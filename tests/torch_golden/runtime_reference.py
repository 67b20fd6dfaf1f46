"""The JAX package's runtime outputs that the port's test files hold the
port against, stored: each ``compute_<name>`` below runs the JAX package
(the tiny model, ``torch_port_common.tiny_jax_model``, on the tests' seeded
images) as the test file's fixture did, and ``<name>.npz`` keeps what it
returned. The JAX package is frozen, so a file changes only with its
inputs; ``tests/test_torch_golden_runtime.py`` (marked slow) computes each
again and asserts it equals the file.

- ``decode`` (``tests/test_torch_decode.py``): the runtime's containers and
  bpp of the two seeded images, its four-part loop on each (the CDF
  indexes and symbols of each step, y_hat), its decode of each, its device
  write plan of each, the write plan and container of the second image
  with ``force_zero_thres`` 0.2, and ``CodecRuntime.decode`` of the second
  container.
- ``evals`` (``tests/test_torch_train_loop.py``,
  ``tests/test_torch_train_levers.py``): the stage-I trainer's
  ``eval_one_epoch`` on each test's folder (as the tests write it) and
  weights: its metrics and what it logged.
- ``serving`` (``tests/test_torch_serving.py``): the five streams of
  ``_images()`` and their bpp, JAX's pipelined ``decode_batch`` of them;
  the first image's container from the calibrated (scale 0.05) weights;
  the second image's container with a caption.
- ``cli`` (``tests/test_torch_inference_cli.py``): every file the JAX
  CLI writes (``evaluate``, ``--serving`` on the same ``Evaluator``, and
  ``quant=w8a8`` on the 64x64 image with both gates at 0) under the
  directories the test compares, keyed by relative path; the CSV
  reports' timing columns, which the test skips, set to 0.
- ``tiled`` (``tests/test_torch_tiled.py``): ``TiledCodec``'s containers,
  infos and decodes of the 128x128 (overlap 0) and 96x96 (overlap 32)
  images, the pass-through container of the 64x64 one at tile 128, the
  96x96 container decoded with overlap 0, the 40x128 container at
  overlap 0, and which error each decode that JAX refuses raises.
- ``z_only`` (``tests/test_torch_z_only.py``): the z-only runtime's
  containers, bpp and decodes of the two seeded images; its codec's
  eval-mode rate-distortion forward and ``decompress_z_only`` on the
  test's seeded inputs.
- ``w8a8`` (``tests/test_torch_w8a8.py``): the w8a8 runtime's streams of
  ``_images()`` and its decodes (gate 0 while it traces), the TinyVAE
  runtime's decode of the first stream, the z-only runtime's decode of the
  port's z indices of the first image (traced after the gate is restored,
  as the fixture did).

Streams are stored as uint8 arrays, bpp dicts as one float per key.

Write the files (about a minute each):
  JAX_PLATFORMS=cpu python tests/torch_golden/runtime_reference.py [name ...]
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE.parent.parent))

NAMES = ("cli", "decode", "evals", "serving", "tiled", "w8a8", "z_only")


def path(name: str) -> Path:
    return HERE / f"{name}.npz"


def load(name: str) -> dict:
    with np.load(path(name)) as f:
        return {k: f[k] for k in f.files}


def stream(arrays: dict, key: str) -> bytes:
    return arrays[key].tobytes()


def bpp(arrays: dict, key: str) -> dict:
    prefix = key + "_bpp/"
    return {k[len(prefix):]: float(v) for k, v in arrays.items()
            if k.startswith(prefix)}


def _put(out: dict, key: str, stream_bytes, bpp_dict=None) -> None:
    out[key] = np.frombuffer(bytes(stream_bytes), np.uint8).copy()
    for k, v in (bpp_dict or {}).items():
        out[f"{key}_bpp/{k}"] = np.float64(v)


def pack_tree(root: Path, dirs) -> dict:
    """Every file under ``root / d`` for d in ``dirs``, as uint8 arrays
    keyed by their path relative to ``root``."""
    out = {}
    for d in dirs:
        for f in sorted((root / d).rglob("*")):
            if f.is_file():
                out[str(f.relative_to(root))] = np.frombuffer(
                    f.read_bytes(), np.uint8).copy()
    return out


def unpack_tree(arrays: dict, root: Path) -> None:
    for rel, data in arrays.items():
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(data.tobytes())


def _zero_timing(root: Path, dirs) -> None:
    """The CSV reports' timing columns (``TIMING`` of the CLI test, which
    it does not compare) set to 0, so a recomputed file equals the stored
    one."""
    import csv

    from test_torch_inference_cli import TIMING

    for d in dirs:
        for f in sorted((root / d).rglob("*.csv")):
            with open(f, newline="") as fh:
                rows = list(csv.DictReader(fh))
            if not rows:
                continue
            with open(f, "w", newline="") as fh:
                writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
                writer.writeheader()
                for r in rows:
                    writer.writerow({k: ("0" if k in TIMING else v)
                                     for k, v in r.items()})


def compute_cli() -> dict:
    import shutil
    import tempfile

    import onedc_tpu.eval.inference as jinference
    import onedc_tpu.nn.quant as jq
    from onedc_tpu.config import Config
    from onedc_tpu.utils.checkpoint import load_safetensors as jax_load
    from test_torch_inference_cli import NAMES as IMAGES
    from test_torch_inference_cli import cli_inputs

    root = Path(tempfile.mkdtemp(prefix="cli_reference_"))
    try:
        cfg = cli_inputs(root)
        load = jinference.load_params
        jinference.load_params = lambda model, c: jax_load(c["ckpt"])
        gate = jq._Q8_MIN_CH
        try:
            ev = jinference.Evaluator(Config.wrap(dict(
                cfg, output_path=str(root / "jax"))))
            ev.evaluate()
            shutil.copytree(root / "jax", root / "jax_serving")
            ev.out_dir = root / "jax_serving"
            ev.evaluate_batched()
            (root / "imgs_w8a8").mkdir()
            shutil.copy(root / "imgs" / f"{IMAGES[0]}.png",
                        root / "imgs_w8a8")
            jq._Q8_MIN_CH = 0
            os.environ["ONEDC_Q8_MIN_CH"] = "0"
            jinference.Evaluator(Config.wrap(dict(
                cfg, quant="w8a8", dataset_path=str(root / "imgs_w8a8"),
                output_path=str(root / "jax_w8a8")))).evaluate()
        finally:
            jinference.load_params = load
            jq._Q8_MIN_CH = gate
            os.environ.pop("ONEDC_Q8_MIN_CH", None)
        dirs = ("jax", "jax_serving", "jax_w8a8")
        _zero_timing(root, dirs)
        return pack_tree(root, dirs)
    finally:
        shutil.rmtree(root)


def text(arrays: dict, key: str) -> str:
    return arrays[key].tobytes().decode()


def _put_text(out: dict, key: str, value: str) -> None:
    out[key] = np.frombuffer(value.encode(), np.uint8).copy()


def compute_evals() -> dict:
    import json
    import tempfile
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    import test_torch_train_levers as levers
    import test_torch_train_loop as loop
    from onedc_tpu.config import Config
    from onedc_tpu.data import datasets as jdata
    from onedc_tpu.train import losses as jlosses
    from onedc_tpu.train import trainer as jtrainer
    from torch_port_common import tiny_jax_model

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for key, codeformer in (("loop", False), ("levers", True)):
            jm, params = tiny_jax_model(codeformer=codeformer)
            jt = jtrainer.Trainer.__new__(jtrainer.Trainer)
            jt.model = jm
            jt.state = SimpleNamespace(params=jax.tree.map(jnp.asarray,
                                                           params))
            if key == "loop":
                root = loop._folder(tmp / key, 3, 80, 140, seed=5)
                jt.cfg = Config.wrap(dict(eval_max_images=2))
                jt.loss = jlosses.RDLoss(
                    lmbda=2.0, lmbda_schedule=loop.LMBDA_SCHEDULE)
                jt.writer = loop._Writer()
                step = 7
            else:
                root = levers._folder(tmp / key, 1, 130, 140, seed=1)
                jt.cfg = Config.wrap(dict(levers.EVAL_WEIGHTS))
                jt.loss = jlosses.RDLoss(lmbda=2.0,
                                         lmbda_schedule=levers.EVAL_SCHEDULE)
                jt.writer = levers._Writer()
                step = 3
            jt.eval_loader = jdata.DataLoader(jdata.ImageFolderDataset(root),
                                              1)
            for k, v in jt.eval_one_epoch(step).items():
                out[f"{key}/metrics/{k}"] = np.float64(v)
            _put_text(out, f"{key}/images", json.dumps(jt.writer.images))
            _put_text(out, f"{key}/dicts", json.dumps(
                [d[:2] for d in getattr(jt.writer, "dicts", [])]))
    return out


def _error_of(fn) -> str:
    """The name of the exception ``fn()`` raises, or "" if none."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 (recorded, not handled)
        return type(e).__name__
    return ""


def compute_tiled() -> dict:
    import json

    import jax.numpy as jnp

    from onedc_tpu.models.onedc import OneDCRuntime as JaxOneDCRuntime
    from onedc_tpu.parallel import tiled as jtiled
    from test_torch_tiled import _image
    from torch_port_common import tiny_jax_model

    jm, params = tiny_jax_model()
    jrt = JaxOneDCRuntime(jm, params)
    jrt.update(force=True)
    out = {}
    for size, overlap in ((128, 0), (96, 32)):
        jtc = jtiled.TiledCodec(jrt, tile=64, overlap=overlap)
        s, info = jtc.encode(jnp.asarray(_image(size, size)))
        _put(out, f"tiled{size}", s)
        out[f"info{size}"] = np.frombuffer(
            json.dumps(info, default=float).encode(), np.uint8).copy()
        out[f"decoded{size}"] = np.asarray(jtc.decode(stream=bytes(s)))
    _put(out, "passthrough64", jtiled.TiledCodec(jrt, tile=128).encode(
        jnp.asarray(_image(64, 64)))[0])
    out["error128_overlap32"] = np.frombuffer(_error_of(
        lambda: jtiled.TiledCodec(jrt, 64, 32).decode(
            stream=stream(out, "tiled128"))).encode(), np.uint8).copy()
    out["decoded96_overlap0"] = np.asarray(jtiled.TiledCodec(
        jrt, 64, 0).decode(stream=stream(out, "tiled96")))
    tc = jtiled.TiledCodec(jrt, 64, 0)
    _put(out, "tiled40x128", tc.encode(jnp.asarray(_image(40, 128)))[0])
    out["error40x128"] = np.frombuffer(_error_of(
        lambda: tc.decode(stream=stream(out, "tiled40x128"))).encode(),
        np.uint8).copy()
    return out


def _jax_loop(jrt, stream_bytes):
    """The JAX four-part loop, step by step: [(indexes, symbols)], y_hat."""
    import jax.numpy as jnp

    from onedc_tpu.entropy.framing import decode_i
    crt = jrt._codec_rt
    dec = decode_i(stream_bytes, crt.fsq.index_bits, jrt.ds)
    zh, zw = dec["pad_height"] // jrt.ds, dec["pad_width"] // jrt.ds
    z = crt.fsq.unpack_indices(dec["bit_stream_z"], zh * zw).reshape(
        1, zh, zw)
    crt.entropy_coder.set_stream(dec["bit_stream_y"])
    st = crt._begin(crt.params, jnp.asarray(z))
    common, steps = st["common"], []
    for step in range(4):
        idx = np.asarray(st["indexes_r"])
        sym = crt.gaussian_coder.decode_stream_with_indexes(idx)
        steps.append((idx, sym))
        st = crt._update[step](crt.params, jnp.asarray(sym), st["means"],
                               st["y_hat"], common)
    return steps, np.asarray(st["y_hat"])


def _write_plan(jrt, image) -> dict:
    import jax.numpy as jnp

    from onedc_tpu.entropy.framing import get_padding_size
    _, h, w, _ = image.shape
    return jrt._encode_dev(jrt.params, jrt._pad_replicate(
        jnp.asarray(image), get_padding_size(h, w, jrt.ds)))


def _put_plan(out: dict, key: str, plan) -> None:
    out[f"{key}/z_indices"] = np.asarray(plan["z_indices"])
    out[f"{key}/y_hat"] = np.asarray(plan["y_hat"])
    for s in range(4):
        out[f"{key}/indexes_w{s}"] = np.asarray(plan["indexes_w"][s])
        out[f"{key}/y_q_w{s}"] = np.asarray(plan["y_q_w"][s])


def compute_decode() -> dict:
    import jax.numpy as jnp

    from onedc_tpu.models.onedc import OneDCRuntime as JaxOneDCRuntime
    from torch_port_common import seeded_images, tiny_jax_model

    jm, params = tiny_jax_model()
    rt = JaxOneDCRuntime(jm, params)
    rt.update(force=True)
    out = {}
    for i, image in enumerate(seeded_images()):
        s, b = rt.encode(jnp.asarray(image))
        _put(out, f"stream{i}", s, b)
        steps, y_hat = _jax_loop(rt, bytes(s))
        for st, (idx, sym) in enumerate(steps):
            out[f"loop{i}/indexes{st}"] = idx
            out[f"loop{i}/symbols{st}"] = np.asarray(sym)
        out[f"loop{i}/y_hat"] = y_hat
        out[f"decoded{i}"] = np.asarray(rt.decode(stream=bytes(s)))
        _put_plan(out, f"plan{i}", _write_plan(rt, image))
    image = seeded_images()[1]
    skip = JaxOneDCRuntime(rt.model.clone(force_zero_thres=0.2), rt.params)
    skip.update(force=True)
    _put_plan(out, "plan1_skip", _write_plan(skip, image))
    s, b = skip.encode(jnp.asarray(image))
    _put(out, "stream1_skip", s, b)
    x_hat, y_sem, hw, pad_hw, pad = rt._codec_rt.decode(
        stream=stream(out, "stream1"))
    out["codec1/x_hat"], out["codec1/y_sem"] = (np.asarray(x_hat),
                                                np.asarray(y_sem))
    out["codec1/geometry"] = np.array([*hw, *pad_hw, *pad], np.int64)
    return out


def compute_serving() -> dict:
    import jax.numpy as jnp

    from onedc_tpu.models.onedc import OneDCRuntime as JaxOneDCRuntime
    from onedc_tpu.utils.calibrate import calibrate_stream_params
    from test_torch_serving import _images
    from torch_port_common import tiny_jax_model

    jm, params = tiny_jax_model()
    rt = JaxOneDCRuntime(jm, params)
    rt.update(force=True)
    out = {}
    streams = []
    for i, im in enumerate(_images()):
        s, b = rt.encode(jnp.asarray(im))
        _put(out, f"stream{i}", s, b)
        streams.append(bytes(s))
    for i, img in enumerate(rt.decode_batch(streams)):
        out[f"decoded{i}"] = np.asarray(img)
    s, b = rt.encode(jnp.asarray(_images()[1]), caption="a caption")
    _put(out, "captioned1", s, b)
    rt.set_params(calibrate_stream_params(params, 0.05))
    s, b = rt.encode(jnp.asarray(_images()[0]))
    _put(out, "calibrated0", s, b)
    return out


def compute_z_only() -> dict:
    import jax
    import jax.numpy as jnp

    from onedc_tpu.models.onedc import OneDCRuntime as JaxOneDCRuntime
    from test_torch_z_only import codec_program_inputs
    from torch_port_common import seeded_images, tiny_jax_model

    jm, params = tiny_jax_model()
    rt = JaxOneDCRuntime(jm.clone(z_only=True), params)
    rt.update(force=True)
    out = {}
    for i, image in enumerate(seeded_images()):
        s, b = rt.encode(jnp.asarray(image))
        _put(out, f"stream{i}", s, b)
        out[f"decoded{i}"] = np.asarray(rt.decode(stream=bytes(s)))
    crt = rt._codec_rt
    codec = crt.codec

    @jax.jit
    def jax_fn(p, x, cond, z):
        fwd = codec.apply(p, x, cond, training=False)
        return fwd, codec.apply(p, z, method=codec.decompress_z_only)

    fwd, (x_hat, y_sem) = jax_fn(crt.params, *codec_program_inputs())
    for k, v in fwd.items():
        out[f"fwd/{k}"] = np.asarray(v)
    out["x_hat"], out["y_sem"] = np.asarray(x_hat), np.asarray(y_sem)
    return out


def compute_w8a8() -> dict:
    import jax.numpy as jnp
    import torch

    import onedc_tpu.nn.quant as jq
    from onedc_tpu.models.onedc import OneDCRuntime as JaxOneDCRuntime
    from onedc_tpu_torch.models.onedc import OneDCRuntime
    from test_torch_w8a8 import _images, _tiny_vae_params
    from torch_port_common import port_model, tiny_jax_model

    jm, params = tiny_jax_model()
    out = {}
    gate = jq._Q8_MIN_CH
    jq._Q8_MIN_CH = 0
    try:
        rt = JaxOneDCRuntime(jm, params, quant="w8a8")
        rt.update(force=True)
        streams = [bytes(rt.encode(jnp.asarray(im))[0]) for im in _images()]
        for i, s in enumerate(streams):
            _put(out, f"stream{i}", s)
            out[f"large{i}"] = np.asarray(rt.decode(stream=s))
        tiny = JaxOneDCRuntime(jm, {"params": _tiny_vae_params(
            jm, params["params"] if "params" in params else params)},
            quant="w8a8", vae="tiny")
        tiny.update(force=True)
        out["tiny"] = np.asarray(tiny.decode(stream=streams[0]))
        z_rt = JaxOneDCRuntime(jm.clone(z_only=True), params, quant="w8a8")
    finally:
        jq._Q8_MIN_CH = gate
    ims = _images()
    exact = OneDCRuntime(port_model(z_only=True), device="cpu")
    with torch.no_grad():
        z = exact.write_plan(np.concatenate([ims[0], ims[2]]))["z_indices"]
    out["z_indices"] = z[:1].numpy()
    out["z_only"] = np.asarray(z_rt._decode_z_only(
        z_rt.params, jnp.asarray(z[:1].numpy())))
    return out


def compute(name: str) -> dict:
    import jax
    jax.config.update("jax_default_matmul_precision", "highest")
    return globals()[f"compute_{name}"]()


if __name__ == "__main__":
    for name in sys.argv[1:] or NAMES:
        arrays = compute(name)
        np.savez_compressed(path(name), **arrays)
        print(f"wrote {path(name)}: {len(arrays)} arrays, "
              f"{path(name).stat().st_size} bytes")
