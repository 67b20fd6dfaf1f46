"""The serving layer of the port on the CPU (tiny geometry, f32): the
pipelined ``decode_batch``, stream-rate calibration, the exported serving
bundle with ``ServingDecoder`` / ``ServingEncoder``, and the kernels'
operators.

Streams come from the JAX package's ``OneDCRuntime.encode`` (64x64, a
ragged 50x39 and a noisy 64x64 share the 64x64 bucket; a 60x128 image
has the 64x128 bucket to itself). Tolerances:
- images against the JAX package's: ``IMAGE_TOL`` (2e-3; the x0 recovery
  divides by sqrt(alpha_bar(999)) ~ 0.069, which amplifies the
  frameworks' f32 differences before the VAE);
- images of the port at other batch sizes: 1e-4 between two chunkings
  that differ in one ragged row (the batch-row tolerance of
  ``test_torch_decode.py``: a batch rounds the batched UNet and VAE
  differently from batch 1), 5e-4 between a chunk of three and single
  decodes (the JAX package's own tolerance for its pipelined against its
  serial decode, ``tests/test_onedc.py:93``; 1.07e-4 measured);
- y_hat against the port's single decode, the calibrated weights against
  JAX's and containers against JAX's: exact.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from onedc_tpu.utils.calibrate import \
    calibrate_stream_params as jax_calibrate
from onedc_tpu_torch.models.onedc import OneDCRuntime
from onedc_tpu_torch.ops import conv3x3 as k2
from onedc_tpu_torch.ops import flash_attention as k1
from onedc_tpu_torch.serving.decoder import ServingDecoder
from onedc_tpu_torch.serving.encoder import ServingEncoder
from onedc_tpu_torch.utils import aot
from onedc_tpu_torch.utils.calibrate import calibrate_stream_params, \
    pick_stream_scale
from onedc_tpu_torch.utils.convert import state_dict_from_jax
from torch_golden import runtime_reference
from torch_port_common import (  # noqa: F401  (a fixture)
    IMAGE_TOL,
    one_torch_thread,
    port_model,
    seeded_images,
    tiny_jax_model,
)

ROOT = Path(__file__).resolve().parents[1]
BATCH_TOL = 1e-4
PIPELINE_TOL = 5e-4
# the JAX tests' schedules (tests/test_onedc.py:73,97,116): the defaults,
# chunks of one image at depth 2, and VAE sub-batches of one image
SCHEDULES = {
    "default": {},
    "chunk1_depth2": {"ONEDC_PIPELINE_CHUNK": "1",
                      "ONEDC_PIPELINE_DEPTH": "2"},
    "vae_chunk1": {"ONEDC_PIPELINE_CHUNK": "3", "ONEDC_VAE_CHUNK": "1"},
}
BUNDLE_BATCH = 2

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _images():
    """(1, H, W, 3) f32: three of the 64x64 bucket, one of 64x128."""
    ims = seeded_images()
    rng = np.random.default_rng(3)
    noisy = np.clip(ims[0] + 0.1 * rng.standard_normal(ims[0].shape), -1,
                    1).astype(np.float32)
    return ims + [noisy, np.tile(ims[0], (1, 1, 2, 1))[:, :60]]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX runtime's streams of ``_images()`` and its pipelined
    decode_batch of them (the default schedule: its other schedules agree
    with it to 5e-4, tests/test_onedc.py:97-136, so each port schedule is
    held against this one decode), stored by
    ``torch_golden/runtime_reference.py``: (the stored arrays, streams,
    decoded images)."""
    gold = runtime_reference.load("serving")
    n = len(_images())
    return (gold, [runtime_reference.stream(gold, f"stream{i}")
                   for i in range(n)],
            [gold[f"decoded{i}"] for i in range(n)])


@pytest.fixture(scope="module")
def port_rt():
    return OneDCRuntime(port_model(), device="cpu")


def _recording(programs, y_hats):
    """``programs`` with its x0 program recording the y_hat it is given."""
    def x0(y_hat, z_semantic):
        y_hats.append(y_hat)
        return programs.x0(y_hat, z_semantic)
    return programs._replace(x0=x0)


@pytest.fixture(scope="module")
def port_side(jax_side, port_rt):
    """Per schedule, the port's decode_batch and the y_hat of each chunk
    that its pipeline reached; and the traced single decodes."""
    _, streams, _ = jax_side
    singles = []
    for s in streams:
        trace = {}
        singles.append((port_rt.decode(s, trace), trace["y_hat"]))
    runs = {}
    for name, env in SCHEDULES.items():
        y_hats = []
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            programs = port_rt.decode_programs
            mp.setattr(port_rt, "decode_programs",
                       lambda: _recording(programs(), y_hats))
            runs[name] = (port_rt.decode_batch(streams), y_hats)
    return singles, runs


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pipelined_decode_batch_matches_jax(jax_side, port_side, schedule):
    """The port's pipelined decode_batch under each schedule against the
    JAX package's, itself pipelined, on mixed buckets: IMAGE_TOL."""
    _, _, jax_decoded = jax_side
    got, _ = port_side[1][schedule]
    for want, img in zip(jax_decoded, got):
        assert img.shape == want.shape and img.dtype == torch.float32
        np.testing.assert_allclose(img.numpy(), want, rtol=0,
                                   atol=IMAGE_TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pipelined_rows_are_the_single_decodes(port_side, schedule):
    """Every row of every chunk of the pipelined 64x64 bucket carries the
    y_hat of its stream's single decode, bit for bit (the prior programs
    run one row at a time); its image is the single decode's within the
    pipeline tolerance. The 64x128 stream, alone in its bucket, is the
    single decode."""
    singles, runs = port_side
    got, y_hats = runs[schedule]
    assert _rows_of(y_hats, singles[:3]) == [0, 1, 2]
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), singles[i][0].numpy(),
                                   rtol=0, atol=PIPELINE_TOL)
    assert torch.equal(got[3], singles[3][0])


def _rows_of(y_hats, singles):
    """For each recorded row (chunks finish in any order), the index of
    the single decode whose y_hat it equals bit for bit, or None; sorted
    with the Nones dropped."""
    rows = torch.cat(y_hats)
    found = []
    for r in range(rows.shape[0]):
        match = [i for i, (_, y) in enumerate(singles)
                 if torch.equal(rows[r:r + 1], y)]
        found += match[:1]
    return sorted(found)


def test_symbols_narrow_to_int8_unless_told_not_to(monkeypatch):
    from onedc_tpu_torch.serving.pipeline import narrow_symbols

    small = np.array([[-128, 0, 127]], np.int16)
    assert narrow_symbols(small).dtype == np.int8
    assert narrow_symbols(np.array([[128]], np.int16)).dtype == np.int16
    monkeypatch.setenv("ONEDC_SYMBOL_I8", "0")
    assert narrow_symbols(small).dtype == np.int16


@pytest.mark.parametrize("scale", [0.05, 0.35, 1.0])
def test_calibrated_state_is_bit_equal_to_jax(scale):
    _, params = tiny_jax_model()
    got = calibrate_stream_params(state_dict_from_jax(params), scale)
    want = state_dict_from_jax(jax_calibrate(params, scale))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    moved = sum(not torch.equal(got[k], v) for k, v in
                state_dict_from_jax(params).items())
    assert moved == (0 if scale == 1.0 else 50)


def test_calibrated_containers_are_jax_bytes(jax_side):
    """A calibrated runtime writes the JAX package's calibrated container
    byte for byte, at under half the raw rate (tests/test_onedc.py:137),
    and decodes it to the writer's y_hat; the runtime's own weights come
    back with scale 1.0."""
    gold, _, _ = jax_side
    rt = OneDCRuntime(port_model(), device="cpu")
    image = _images()[0]
    _, raw = rt.encode(image)
    base = {k: v.clone() for k, v in rt.model.state_dict().items()}
    rt.set_params(calibrate_stream_params(base, 0.05))
    stream, bpp = rt.encode(image)
    # the JAX runtime's container of the image with
    # ``jax_calibrate(params, 0.05)``, stored
    assert stream == runtime_reference.stream(gold, "calibrated0")
    assert bpp["bpp_y"] < 0.5 * raw["bpp_y"]
    trace = {}
    assert torch.isfinite(rt.decode(stream, trace)).all()
    assert torch.equal(trace["y_hat"], rt.write_plan(image)["y_hat"])
    rt.set_params(calibrate_stream_params(base, 1.0))
    assert rt.encode(image)[1] == raw


def test_pick_stream_scale_takes_the_first_scale_in_the_band():
    rates = {0.5: 2.0, 0.35: 1.0, 0.25: 0.1, 0.18: 0.05}
    assert pick_stream_scale(rates.get, candidates=tuple(rates)) == (0.25,
                                                                     0.1)
    assert pick_stream_scale(lambda s: 1 + s, candidates=(0.5, 0.3)) == (
        0.3, 1.3)


@pytest.fixture(scope="module")
def bundle(port_rt, tmp_path_factory):
    """A 64x64 x 2 serving bundle and its weights file."""
    out = tmp_path_factory.mktemp("bundle")
    arts = aot.export_serving_bundle(port_rt, 64, 64, batch=BUNDLE_BATCH)
    aot.save_bundle(arts, out)
    aot.save_weights(port_rt, out / "weights.safetensors")
    return out


@pytest.fixture(scope="module")
def served(bundle, jax_side):
    """ServingDecoder's decode of the three 64x64 streams (a chunk of two
    and a ragged one) and the y_hat rows its pipeline reached."""
    dec = ServingDecoder(bundle, bundle / "weights.safetensors",
                         device="cpu")
    y_hats = []
    programs = dec._programs
    dec._programs = lambda: _recording(programs(), y_hats)
    return dec, dec.decode_batch(jax_side[1][:3]), y_hats


def test_bundle_meta_and_files(bundle):
    import json

    meta = json.loads((bundle / "meta.json").read_text())
    for key in ("height", "width", "batch", "ds", "z_fsq_levels", "dtype",
                "indexes_dtype", "symbol_dtypes", "quant", "vae"):
        assert key in meta, key
    assert (meta["height"], meta["width"], meta["batch"]) == (64, 64, 2)
    assert meta["quant"] is None and meta["vae"] == "large"
    assert meta["symbol_dtypes"] == ["int16", "int8"]
    # the JAX bundle's programs (onedc_tpu/utils/aot.py:123-193)
    assert sorted(p.stem for p in bundle.glob("*.pt2")) == sorted(
        ["begin", "x0", "vae", "decode", "encode"]
        + [f"update{s}{x}" for s in range(4) for x in ("", "_i8")])


def test_serving_decoder_matches_the_runtime(served, port_side, port_rt,
                                             jax_side, monkeypatch):
    """Bundle images against the runtime's pipelined decode at the
    bundle's chunking within the batch-row tolerance (the ragged chunk
    pads to the exported batch), y_hat rows bit-identical to the single
    decodes', images against JAX's decode_batch within IMAGE_TOL."""
    _, got, y_hats = served
    singles, _ = port_side
    monkeypatch.setenv("ONEDC_PIPELINE_CHUNK", str(BUNDLE_BATCH))
    monkeypatch.setenv("ONEDC_VAE_CHUNK", str(BUNDLE_BATCH))
    want = port_rt.decode_batch(jax_side[1][:3])
    # two chunks of the exported batch, the last with one padding row
    assert sum(y.shape[0] for y in y_hats) == 2 * BUNDLE_BATCH
    assert _rows_of(y_hats, singles[:3]) == [0, 1, 2]
    for i in range(3):
        assert got[i].shape == want[i].shape
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(), rtol=0,
                                   atol=BATCH_TOL)
        np.testing.assert_allclose(got[i].numpy(), jax_side[2][i], rtol=0,
                                   atol=IMAGE_TOL)


def test_serving_decoder_rejects_another_bucket(served, jax_side):
    dec = served[0]
    with pytest.raises(ValueError, match="bundle bucket is 64x64"):
        dec.decode_batch([jax_side[1][3]])


def test_serving_encoder_writes_jax_containers(bundle, jax_side, port_rt):
    """ServingEncoder's containers (a chunk of two and a ragged one, one
    with a caption) equal JAX ``encode``'s byte for byte; an image of
    another bucket raises."""
    gold = jax_side[0]
    enc = ServingEncoder(bundle, port_rt.model.state_dict(), device="cpu")
    images = _images()
    caps = ["", "a caption", ""]
    got = enc.encode_batch(images[:3], captions=caps)
    # JAX ``encode(image, caption=cap)``'s containers, stored (the empty
    # caption is ``encode``'s default)
    for key, (stream, bpp) in zip(("stream0", "captioned1", "stream2"), got):
        assert stream == runtime_reference.stream(gold, key)
        assert bpp == pytest.approx(runtime_reference.bpp(gold, key))
    with pytest.raises(ValueError, match="bundle bucket is 64x64"):
        enc.encode_batch([images[3]])


def _imports(path: Path, package_root: Path):
    """The onedc_tpu_torch modules a source file imports, anywhere in it,
    with their parent packages (whose __init__ runs first)."""
    pkg = list(path.relative_to(package_root.parent).parts[:-1])
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            base = (pkg[:len(pkg) - node.level + 1] if node.level else [])
            mod = base + (node.module.split(".") if node.module else [])
            names = [mod] + [mod + [a.name] for a in node.names]
        elif isinstance(node, ast.Import):
            names = [a.name.split(".") for a in node.names]
        else:
            continue
        for name in names:
            if name[:1] == ["onedc_tpu_torch"]:
                for i in range(1, len(name) + 1):
                    found.add(".".join(name[:i]))
    return found


def test_serving_modules_import_no_model_code():
    """The bundle decoder and encoder reach, through every import in
    onedc_tpu_torch (module level or inside a function), none of models/,
    eval/, train/ and of nn/ only the stateless fsq.py."""
    pkg = ROOT / "onedc_tpu_torch"

    def source(mod):
        p = ROOT.joinpath(*mod.split("."))
        return p / "__init__.py" if p.is_dir() else p.with_suffix(".py")

    seen, todo = set(), ["onedc_tpu_torch.serving.decoder",
                         "onedc_tpu_torch.serving.encoder"]
    while todo:
        mod = todo.pop()
        if mod in seen or not source(mod).exists():
            continue
        seen.add(mod)
        todo.extend(_imports(source(mod), pkg) - seen)
    assert "onedc_tpu_torch.serving.bundle" in seen
    assert "onedc_tpu_torch.nn.fsq" in seen
    model_code = sorted(
        m for m in seen if m.split(".")[1:2] in (["models"], ["eval"],
                                                 ["train"])
        or (m.startswith("onedc_tpu_torch.nn.")
            and m != "onedc_tpu_torch.nn.fsq"))
    assert model_code == []


@pytest.mark.parametrize("which", ["k1", "k2_f32", "k2_bf16"])
def test_kernel_ops_pass_opcheck(which):
    """The operators that exported programs record: schema, fake
    implementation and autograd registration as ``torch.library.opcheck``
    checks them on the CPU."""
    gen = torch.Generator().manual_seed(0)
    if which == "k1":
        q, k, v = (torch.randn(1, 256, 2, 8, generator=gen)
                   for _ in range(3))
        torch.library.opcheck(k1.flash_attention_op, (q, k, v, 0.3))
        return
    dtype = torch.float32 if which == "k2_f32" else torch.bfloat16
    x = torch.randn(2, 5, 7, 64, generator=gen).to(dtype)
    mul, add = (torch.randn(2, 64, generator=gen) for _ in range(2))
    w = (0.05 * torch.randn(3, 3, 64, 64, generator=gen)).to(dtype)
    bias = torch.randn(64, generator=gen).to(dtype)
    torch.library.opcheck(k2.affine_silu_conv3x3_op, (x, mul, add, w, bias))


def test_bundle_programs_keep_the_operators(served, bundle, port_rt):
    """The loaded VAE program calls K2's operator, not a plain version in
    its place; the artifacts hold no weight (together they are smaller
    than the weights they run)."""
    modules = served[0].bundle.modules
    targets = {str(n.target) for n in modules["vae"].graph.nodes
               if n.op == "call_function"}
    assert "onedc.affine_silu_conv3x3.default" in targets
    weights = sum(v.numel() * v.element_size()
                  for v in port_rt.model.state_dict().values())
    assert sum(p.stat().st_size for p in bundle.glob("*.pt2")) < weights


def test_runtime_decode_batch_is_pinned(port_rt, jax_side, monkeypatch):
    """decode_batch runs inside the package's pinned numerics."""
    from onedc_tpu_torch.utils import numerics

    seen = []
    programs = port_rt.decode_programs

    def spy():
        seen.append(numerics.current() == numerics.PINNED)
        return programs()
    monkeypatch.setattr(port_rt, "decode_programs", spy)
    port_rt.decode_batch(jax_side[1][:2])
    assert seen == [True]
