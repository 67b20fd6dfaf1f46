"""The port's inference CLI (``onedc_tpu_torch/eval/inference.py``)
against the JAX package's on the same ``ckpt=`` file, at the tiny
geometry, f32, on the CPU; its image files against PIL and its config
overrides against the JAX package's.

The JAX ``Evaluator`` runs as it is, but for its ``load_params``: the
test reads the same file with the JAX package's ``load_safetensors`` and
skips the jitted init that would only check the tree against it (tens of
seconds of XLA compile on a CPU).
"""

import csv
import json
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from torch_port_common import (  # noqa: F401  (a fixture)
    fill_params,
    one_torch_thread,
    tiny_jax_model,
)

import jax
import jax.numpy as jnp
from onedc_tpu.config import Config
from onedc_tpu.config import parse_cli_overrides as jax_parse_cli_overrides
from onedc_tpu.data import datasets as jdata
from onedc_tpu.eval import inference as jinference
from onedc_tpu.nn.vae import TinyVaeDecoder as JaxTinyVaeDecoder
from onedc_tpu.utils.checkpoint import load_safetensors as jax_load
from onedc_tpu.utils.checkpoint import save_safetensors as jax_save
from onedc_tpu_torch.config import load_config, parse_cli_overrides
from onedc_tpu_torch.data import images as port_images
from onedc_tpu_torch.data.images import load_image, save_image, write_png
from onedc_tpu_torch.entropy.framing import decode_i, read_from_file
from onedc_tpu_torch.eval.inference import Evaluator, main
from onedc_tpu_torch.models.onedc import OneDCRuntime
from onedc_tpu_torch.nn.vae import TinyVaeDecoder
from onedc_tpu_torch.utils.convert import state_dict_from_jax

TINY_MODEL = dict(
    internal_ch=64, bottleneck_ch=32, unet_ch_config=[32, 64, 64],
    ctrl_ch=32, sd_block_channels=[32, 32, 64, 64], context_dim=64,
    vae_block_channels=[32, 32, 64, 64], vae_attn_patch=4,
)
NAMES = ("kodim01", "kodim02")
CAPTION = "a red boat on a lake"
TIMING = ("enc_s", "dec_s", "encodes_per_sec", "decodes_per_sec")
# recon PNGs against the JAX CLI's. The limit first set for them was at
# most 1 level on at most 0.1 % of the values (RECON_EXACT_SHARE); the
# port and the JAX CLI miss it on the 64x64 image (1 level on 0.38 %),
# with their streams byte-identical. Both take the GroupNorm variance as
# E[x^2] - mean^2 in f32, and the tiny codec's groups (one or two channels
# on a 4x4 grid) are near constant, so the two frameworks' sums cancel
# differently. test_recon_gap_is_the_groupnorm_variance holds that
# explanation against exact arithmetic: with the variance taken in two
# passes, the port's f32 decode agrees with its f64 decode to the 0.1 %,
# and neither f32 side is the closer one. A systematic fault (an offset,
# a wrong rounding, another image) moves most values.
RECON_MAX_LEVELS = 1
RECON_MAX_SHARE = 1e-2
RECON_EXACT_SHARE = 1e-3


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The JAX CLI's and the port's runs on one checkpoint (the weights
    of ``torch_port_common.tiny_jax_model``, as every decode parity test
    of the port) and two images (64x64 and 50x70, PNGs written by PIL):
    JAX ``evaluate`` and ``--serving``; the port's ``evaluate``,
    ``--serving`` and ``--decoder_only`` (fresh ``Evaluator``)."""
    root = tmp_path_factory.mktemp("cli")
    jax_save(tiny_jax_model()[1], root / "ckpt.safetensors")
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    for name, shape in zip(NAMES, [(64, 64, 3), (50, 70, 3)]):
        jdata.save_image(rng.uniform(-1, 1, shape).astype(np.float32),
                         root / "imgs" / f"{name}.png")
    (root / "captions.json").write_text(json.dumps({NAMES[0]: CAPTION}))
    cfg = dict(model=TINY_MODEL, ckpt=str(root / "ckpt.safetensors"),
               dataset_path=str(root / "imgs"), use_bf16=False, seed=0,
               captions_file=str(root / "captions.json"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinference, "load_params",
                   lambda model, c: jax_load(c["ckpt"]))
        ev = jinference.Evaluator(Config.wrap(dict(
            cfg, output_path=str(root / "jax"))))
        ev.evaluate()
        shutil.copytree(root / "jax", root / "jax_serving")
        ev.out_dir = root / "jax_serving"
        ev.evaluate_batched()

    (root / "port.yaml").write_text(yaml.safe_dump(dict(cfg, device="cpu")))
    config = ["--config", str(root / "port.yaml")]
    main(config + [f"output_path={root / 'port'}"])
    main(config + ["--serving", f"output_path={root / 'port_serving'}"])
    main(config + ["--decoder_only", "--decoder_bin_path",
                   str(root / "port" / "bin"),
                   f"output_path={root / 'port_decoder_only'}"])
    return root, cfg


def _png(path) -> np.ndarray:
    """An 8-bit RGB file as (H, W, 3) uint8, read by PIL."""
    return jdata.load_image(path, to_float=False)


def _table(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _assert_bpp_tables_equal(got, want):
    assert [list(r) for r in got] == [list(r) for r in want]  # columns
    for g, w in zip(got, want):
        for k in w:
            if k == "name":
                assert g[k] == w[k]
            elif k not in TIMING:
                assert float(g[k]) == float(w[k]), k


@pytest.mark.parametrize("mode", ["evaluate", "serving"])
def test_streams_and_bpp_tables_equal_the_jax_clis(cli, mode):
    """Per image and under ``--serving``, the port writes the JAX CLI's
    ``.bin`` bytes and its bpp tables (timing columns aside)."""
    root, _ = cli
    port, jax_dir = (("port", "jax") if mode == "evaluate"
                     else ("port_serving", "jax_serving"))
    for name in NAMES:
        assert (root / port / "bin" / f"{name}.bin").read_bytes() == \
            (root / jax_dir / "bin" / f"{name}.bin").read_bytes(), name
    for report in ("bpp_detail.csv", "bpp_summary.csv"):
        _assert_bpp_tables_equal(_table(root / port / report),
                                 _table(root / jax_dir / report))
    summary = _table(root / port / "bpp_summary.csv")[0]
    if mode == "serving":
        assert float(summary["encodes_per_sec"]) > 0
        assert float(summary["decodes_per_sec"]) > 0


@pytest.mark.parametrize("mode", ["evaluate", "serving"])
def test_recon_pngs_agree_with_the_jax_clis(cli, mode):
    root, _ = cli
    port, jax_dir = (("port", "jax") if mode == "evaluate"
                     else ("port_serving", "jax_serving"))
    for name in NAMES:
        got = _png(root / port / "recon" / f"{name}.png").astype(int)
        want = _png(root / jax_dir / "recon" / f"{name}.png").astype(int)
        diff = np.abs(got - want)
        share = (diff > 0).mean()
        print(f"{mode} {name}: max {diff.max()} levels on {share:.3%} of "
              f"the pixel channels")
        assert diff.max() <= RECON_MAX_LEVELS and share <= RECON_MAX_SHARE


def _levels(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) in [-1, 1] -> its 8-bit values, as ``save_image`` rounds
    them."""
    return np.clip((image + 1.0) * 127.5 + 0.5, 0, 255).astype(int)


def _two_pass_group_norm_affine(x, weight, bias, num_groups=32, eps=1e-6):
    """``nn/blocks.py:group_norm_affine`` with the variance as the mean of
    squared deviations from the mean (no cancellation)."""
    b, c = x.shape[:2]
    cpg = c // num_groups
    xg = x.float().reshape(b, num_groups, -1)
    mean_g = xg.mean(-1)
    var_g = ((xg - mean_g[..., None]) ** 2).mean(-1)
    mul = (torch.rsqrt(var_g + eps).repeat_interleave(cpg, dim=1)
           * weight.float())
    return mul, bias.float() - mean_g.repeat_interleave(cpg, dim=1) * mul


def test_recon_gap_is_the_groupnorm_variance(cli):
    """The second witness for RECON_MAX_SHARE. From the y_hat and
    z_semantic of each ``.bin`` (the port's decode, recorded), the
    decode's device half runs three more ways on the port's model: in f64
    (``.float()`` keeps f64 here, so every sum the modules widen to f32
    stays f64), and in f32 with the GroupNorm variance taken in two
    passes. The two-pass f32 image is within RECON_EXACT_SHARE of the f64
    one; the port's PNG is no further from it than the JAX CLI's."""
    from torch_port_common import port_model

    from onedc_tpu_torch.nn import blocks

    root, _ = cli
    model = port_model()
    rt = OneDCRuntime(model, device="cpu")
    model64 = port_model().double()
    float32 = torch.Tensor.float

    def keep_f64(t, *args, **kwargs):
        return t if t.dtype == torch.float64 else float32(t, *args,
                                                          **kwargs)

    def device_half(m, y_hat, z_semantic, h, w):
        with torch.no_grad():
            image = m.decode_device_vae(m.decode_device_x0(y_hat,
                                                           z_semantic))
        return image.permute(0, 2, 3, 1)[0, :h, :w].numpy()

    for name in NAMES:
        seen = {}
        x0_of = model.decode_device_x0

        def record(y_hat, z_semantic):
            seen["args"] = (y_hat, z_semantic)
            return x0_of(y_hat, z_semantic)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(model, "decode_device_x0", record)
            port32 = rt.decode(read_from_file(
                root / "port" / "bin" / f"{name}.bin"))[0].numpy()
        h, w = port32.shape[:2]
        png = {run: _png(root / run / "recon" / f"{name}.png").astype(int)
               for run in ("port", "jax")}
        np.testing.assert_array_equal(_levels(port32), png["port"])
        y_hat, z_semantic = seen["args"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "float", keep_f64)
            exact = _levels(device_half(model64, y_hat.double(),
                                        z_semantic.double(), h, w))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(blocks, "group_norm_affine",
                       _two_pass_group_norm_affine)
            two_pass = _levels(device_half(model, y_hat, z_semantic, h, w))

        def gap(levels):
            diff = np.abs(levels - exact)
            return diff.max(), (diff > 0).mean()
        gaps = {"two-pass f32": gap(two_pass), "port": gap(png["port"]),
                "jax": gap(png["jax"])}
        print(name, {k: f"max {m} levels on {s:.3%}"
                     for k, (m, s) in gaps.items()})
        m, share = gaps["two-pass f32"]
        assert m <= RECON_MAX_LEVELS and share <= RECON_EXACT_SHARE, name
        assert gaps["port"][1] <= gaps["jax"][1], name


def test_decoder_only_writes_evaluates_pngs(cli):
    """``--decoder_only`` in a fresh ``Evaluator`` decodes the ``.bin``
    files alone to the PNG bytes ``evaluate()`` wrote; the serving run's
    streams and PNGs are the per-image run's too."""
    root, _ = cli
    for name in NAMES:
        png = (root / "port" / "recon" / f"{name}.png").read_bytes()
        assert (root / "port_decoder_only" / "recon"
                / f"{name}.png").read_bytes() == png
        assert (root / "port_serving" / "bin" / f"{name}.bin").read_bytes() \
            == (root / "port" / "bin" / f"{name}.bin").read_bytes()


def test_caption_rides_the_container(cli):
    root, _ = cli
    for name, caption in zip(NAMES, (CAPTION, "")):
        dec = decode_i(read_from_file(root / "port" / "bin" / f"{name}.bin"),
                       14, 64)
        assert dec["bit_stream_caption"] == caption.encode()
    rows = {r["name"]: r for r in _table(root / "port" / "bpp_detail.csv")}
    assert float(rows[NAMES[0]]["bits_caption"]) == len(CAPTION) * 8


@pytest.mark.parametrize("fault", ["both_sources", "w8a8"])
def test_config_faults_raise(cli, fault):
    """Both weight sources at once, and an unknown quant mode (the case
    named w8a8 held the refusal of ``quant=w8a8`` before the mode was
    ported; ``test_w8a8_cli_matches_the_jax_clis`` runs it now)."""
    root, cfg = cli
    cfg = dict(cfg, device="cpu", output_path=str(root / "faults"))
    if fault == "both_sources":
        with pytest.raises(ValueError, match="ambiguous"):
            Evaluator(dict(cfg, checkpoint_path=str(root)))
    else:
        with pytest.raises(ValueError, match="unknown quant mode"):
            Evaluator(dict(cfg, quant="w4a4"))


def _psnr_levels(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


def test_w8a8_cli_matches_the_jax_clis(cli, monkeypatch):
    """``quant=w8a8`` (both gates at 0: the tiny widths sit below 512)
    writes the exact CLI's ``.bin`` files, and recon PNGs held to the JAX
    CLI's under ``quant=w8a8`` as ``tests/test_torch_w8a8.py`` holds a
    w8a8 decode: a whole w8a8 decode is no bit-level function of its
    input (a one-ulp difference before a quantize moves a value by a whole
    int8 level, and over the decode's quantized ops such steps grow to the
    quantization noise), so the two w8a8 PNGs lie about as far apart as
    the w8a8 PNG from the exact one: PSNR to JAX's at most 3 dB under PSNR
    to the exact PNG, both above 25 dB (the floor of
    ``tests/test_quant.py``), and the w8a8 PNG not the exact one."""
    import onedc_tpu.nn.quant as jq

    root, cfg = cli
    name = NAMES[0]  # the 64x64 image: one padded size, one JAX compile
    (root / "imgs_w8a8").mkdir()
    shutil.copy(root / "imgs" / f"{name}.png", root / "imgs_w8a8")
    cfg = dict(cfg, quant="w8a8", dataset_path=str(root / "imgs_w8a8"))
    monkeypatch.setattr(jq, "_Q8_MIN_CH", 0)
    monkeypatch.setenv("ONEDC_Q8_MIN_CH", "0")
    with monkeypatch.context() as mp:
        mp.setattr(jinference, "load_params",
                   lambda model, c: jax_load(c["ckpt"]))
        jinference.Evaluator(Config.wrap(dict(
            cfg, output_path=str(root / "jax_w8a8")))).evaluate()
    main(["--config", str(root / "port.yaml"), "quant=w8a8",
          f"dataset_path={root / 'imgs_w8a8'}",
          f"output_path={root / 'port_w8a8'}"])
    assert (root / "port_w8a8" / "bin" / f"{name}.bin").read_bytes() == \
        (root / "port" / "bin" / f"{name}.bin").read_bytes()
    png = {run: _png(root / run / "recon" / f"{name}.png").astype(int)
           for run in ("port_w8a8", "jax_w8a8", "port")}
    to_jax = _psnr_levels(png["port_w8a8"], png["jax_w8a8"])
    to_exact = _psnr_levels(png["port_w8a8"], png["port"])
    print(f"{name}: w8a8 PNG to the JAX CLI's w8a8 PNG {to_jax:.2f} dB, to "
          f"the exact PNG {to_exact:.2f} dB")
    assert to_jax >= to_exact - 3.0 and min(to_jax, to_exact) > 25.0
    assert not np.array_equal(png["port_w8a8"], png["port"])


def test_tiny_vae_decoder_matches_jax():
    """``TinyVaeDecoder`` against the JAX package's on the same weights
    (``state_dict_from_jax``), f32: within 1e-5 of the image's range."""
    jm = JaxTinyVaeDecoder(ch=16)
    z = np.random.default_rng(3).standard_normal((2, 6, 5, 4)).astype(
        np.float32) * 3
    params = fill_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                        jnp.asarray(z)),
                         np.random.default_rng(5))
    want = np.asarray(jax.jit(jm.apply)(params, z))
    dec = TinyVaeDecoder(16)
    dec.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = dec(torch.from_numpy(z).permute(0, 3, 1, 2)).permute(0, 2, 3,
                                                                   1).numpy()
    assert got.shape == want.shape == (2, 48, 40, 3)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_tiny_vae_cli_decodes_through_the_tinyvae(cli):
    """``vae=tiny`` with ``tiny_vae_ckpt=`` (a JAX TinyVAE tree, 16
    channels): the checkpoint's decoder, in a runtime that decodes the
    large VAE run's ``.bin`` files to other images of the same sizes. The
    choice is the runtime's: a ``vae="large"`` runtime on the same model
    decodes ``evaluate()``'s image, and the TinyVAE runtime its own."""
    root, cfg = cli
    jm = JaxTinyVaeDecoder(ch=16)
    params = fill_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8, 8, 4))),
                         np.random.default_rng(6))
    jax_save(params, root / "tiny.safetensors")
    ev = Evaluator(dict(cfg, device="cpu", vae="tiny",
                        model=dict(TINY_MODEL, tiny_vae_ch=16),
                        tiny_vae_ckpt=str(root / "tiny.safetensors"),
                        output_path=str(root / "port_tiny")))
    ev.decode_only(root / "port" / "bin")
    assert not ev.runtime.use_large_vae and ev.model.use_large_vae
    want = state_dict_from_jax(params)
    got = ev.model.vae_tiny_dec.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    for name in NAMES:
        tiny = _png(root / "port_tiny" / "recon" / f"{name}.png")
        large = _png(root / "port" / "recon" / f"{name}.png")
        assert tiny.shape == large.shape and not np.array_equal(tiny, large)
    stream = read_from_file(root / "port" / "bin" / f"{NAMES[0]}.bin")
    large_rt = OneDCRuntime(ev.model, device="cpu", vae="large")
    for rt, run in ((large_rt, "port"), (ev.runtime, "port_tiny")):
        save_image(rt.decode(stream)[0].numpy(), root / "again.png")
        assert (root / "again.png").read_bytes() == \
            (root / run / "recon" / f"{NAMES[0]}.png").read_bytes(), run


def _filtered_png(pixels: np.ndarray, filters) -> bytes:
    """A PNG of (H, W, C) uint8 whose row y is coded with filter
    filters[y % len(filters)] (the PNG specification's five)."""
    h, w, ch = pixels.shape
    rows = pixels.reshape(h, w * ch).astype(int)
    out = []
    prev = np.zeros(w * ch, int)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(ch, int), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, int), prev[:-ch]])
        kind = filters[y % len(filters)]
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = [0, left, prev, (left + prev) // 2,
                np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))][kind]
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    color = {1: 0, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reader_and_writer_match_pil(tmp_path, channels):
    """Gray, RGB and RGBA: every row filter read as PIL reads it; the
    writer's files read by PIL; ``load_image`` equals the JAX package's
    (PIL ``convert("RGB")``, scaled to [-1, 1])."""
    from PIL import Image

    rng = np.random.default_rng(channels)
    pixels = rng.integers(0, 256, (13, 11, channels), dtype=np.uint8)
    pixels[4:8] = 255 - pixels[4:8] // 7  # smooth runs too
    for filters in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0]):
        path = tmp_path / f"f{''.join(map(str, filters))}.png"
        path.write_bytes(_filtered_png(pixels, filters))
        pil = np.asarray(Image.open(path)).reshape(pixels.shape)
        np.testing.assert_array_equal(pil, pixels)
        np.testing.assert_array_equal(port_images._read_png(path), pixels)
        np.testing.assert_array_equal(load_image(path),
                                      jdata.load_image(path))
    written = tmp_path / "written.png"
    write_png(written, pixels)
    np.testing.assert_array_equal(
        np.asarray(Image.open(written)).reshape(pixels.shape), pixels)


def test_cli_overrides_match_jax():
    """``parse_cli_overrides`` types tokens as the JAX package's does, and
    ``load_config`` merges them over the YAML file as its does."""
    tokens = ["seed=3", "model.internal_ch=64", "lr=1e-4", "name=kodim",
              "--use_bf16=false", "model.unet_ch_config=[32, 64, 64]",
              "quant=null", "output_path=out/a=b", "x.y.z=2.5"]
    assert parse_cli_overrides(tokens) == \
        jax_parse_cli_overrides(tokens).to_dict()
    with pytest.raises(ValueError, match="key=value"):
        parse_cli_overrides(["seed"])
    base = str(Path(__file__).resolve().parents[1] / "configs"
               / "inference_lambda.yaml")
    assert load_config(base, tokens) == \
        jinference.load_config(base, tokens).to_dict()
