"""chip_smoke.py's tables of kernel shapes and launches, held against
what the full-width model's structure launches (on meta tensors), and its
limits on K1's row log-sum-exp (moved out of
``test_torch_train_step.py``, whose module fixture runs the JAX step for
minutes, so that these run on another worker), the launches of the
pipelined serving schedule, the w8a8 phase's quantized ops, the quality
phase's launches and plain reference, the training phase's LPIPS
config, the tiled and training-loop phases' plans and launches, and the
stage-I yaml phase's shapes, launches with remat, and config."""

from pathlib import Path

import numpy as np
import pytest
import torch


def test_chip_smoke_tables_count_each_steps_launches():
    """chip_smoke.py holds each kernel at every shape a training step gives
    it: per step resolution, the launch counts of its shape tables add up
    to the launches it expects of that step."""
    import chip_smoke as cs

    for res, want in cs.TRAIN_PER_STEP.items():
        bucket = f"train{res}"
        got = tuple(sum(n for _, n in table[bucket]) for table in (
            cs.K1_TRAIN_SHAPES, cs.K1_TRAIN_SHAPES, cs.K2_TRAIN_SHAPES,
            cs.K3_TRAIN_SHAPES))
        assert got == want, bucket


def _recorded_launches(monkeypatch):
    """Patches K2's entry point and every attention entry point (the
    encoder UNet's, the SD UNet's and the VAE mid-block's) to record the
    shapes that would launch K2 and, by the routing rule, K1, and to return
    empty tensors of the right shape, so that the full-width model runs on
    meta tensors: (K1 counter, K2 counter)."""
    from collections import Counter

    from onedc_tpu_torch.nn import attention, unet_enc, unet_sd, vae

    k1, k2 = Counter(), Counter()

    def conv(x, mul, add, w, bias):
        k2[(*x.shape, w.shape[3])] += 1
        return x.new_empty((*x.shape[:3], w.shape[3]))

    def attend(q, k, v, scale=None, route_n=None):  # (B, N, H, D)
        # a spatial band's queries (route_n: the image's) against every
        # band's keys record as (B, N, M, H, D)
        if attention.can_flash(route_n or q.shape[1], k.shape[1]):
            b, n, h, d = q.shape
            k1[(b, n, h, d) if route_n is None else
               (b, n, k.shape[1], h, d)] += 1
        return torch.empty_like(q)

    def attend_bhnd(q, k, v, scale=None, route_n=None):  # (B, H, N, D)
        attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               route_n=route_n)
        return torch.empty_like(q)

    monkeypatch.setattr(vae, "affine_silu_conv3x3", conv)
    monkeypatch.setattr(vae, "multi_head_attention", attend_bhnd)
    monkeypatch.setattr(unet_enc, "multi_head_attention_bnhd", attend)
    monkeypatch.setattr(unet_sd, "multi_head_attention_bnhd", attend)
    return k1, k2


def test_chip_smoke_encode_tables_count_each_encodes_launches(monkeypatch):
    """chip_smoke.py's encode tables hold what the full-width model's
    structure launches per encode: the device half (VAE encoder and codec
    encoder) runs on meta tensors with the launches recorded. 768x768
    gives the ``encode768`` shapes, 512x704 the ``encode512x704`` one (the
    VAE mid-block's global attention), and each size the launches of
    ENCODE_PER_CALL."""
    from collections import Counter

    import chip_smoke as cs
    from onedc_tpu_torch.models.onedc import OneDC

    k1, k2 = _recorded_launches(monkeypatch)
    with torch.device("meta"):
        model = OneDC()
    for (h, w), want in cs.ENCODE_PER_CALL.items():
        k1.clear()
        k2.clear()
        with torch.no_grad():
            x = torch.empty((1, 3, h, w), device="meta")
            model.codec.enc(x, model.vae_encode_image(x))
        assert (sum(k1.values()), sum(k2.values())) == want, (h, w)
        if (h, w) == (768, 768):
            assert k1 == Counter(dict(cs.K1_SHAPES["encode768"]))
            assert k2 == Counter(dict(cs.K2_SHAPES["encode768"]))
        if (h, w) == (512, 704):
            assert k1 == Counter(dict(cs.K1_SHAPES["encode512x704"]))


def test_chip_smoke_decode_tables_count_each_decodes_launches(monkeypatch):
    """chip_smoke.py's decode tables hold what the full-width model's
    structure launches per decode: the z-only model's device decode (the
    lambda decode's codec finish, UNet and VAE, from z alone) runs on meta
    tensors with the launches recorded. Each padded size gives the
    launches of K1_PER_CALL / K2_PER_CALL, 768x768 and 512x768 their
    kernel-phase shapes, and 512x704 the VAE decoder's global attention at
    the ``encode512x704`` shape beside the UNet's five."""
    from collections import Counter

    import chip_smoke as cs
    from onedc_tpu_torch.models.onedc import OneDC

    k1, k2 = _recorded_launches(monkeypatch)
    with torch.device("meta"):
        model = OneDC(z_only=True)
    for bucket in cs.K1_PER_CALL:
        h, w = map(int, bucket.split("x"))
        k1.clear()
        k2.clear()
        with torch.no_grad():
            z = torch.zeros((1, h // 64, w // 64), dtype=torch.int32,
                            device="meta")
            assert model.decode_device_z_only(z).shape == (1, 3, h, w)
        assert (sum(k1.values()), sum(k2.values())) == (
            cs.K1_PER_CALL[bucket], cs.K2_PER_CALL[bucket]), bucket
        if bucket in cs.K2_SHAPES:
            assert k1 == Counter(dict(cs.K1_SHAPES[bucket]))
            assert k2 == Counter(dict(cs.K2_SHAPES[bucket]))
        if bucket == "512x704":
            for shape, n in cs.K1_SHAPES["encode512x704"]:
                assert k1[shape] == n


@pytest.mark.parametrize("shape", [(1, 2304, 4, 8), (1, 4096, 2, 40)])
def test_chip_smoke_lse_limits_tell_a_skipped_tile(shape):
    """chip_smoke.py's limits on K1's row log-sum-exp admit the rounding of
    q and k to bf16 (what the kernel stages) and fail the plain LSE with
    one 64-key tile left out."""
    import chip_smoke as cs
    from onedc_tpu_torch.ops import flash_attention as k1

    gen = torch.Generator().manual_seed(shape[1])
    q, k = (torch.randn(shape, generator=gen) for _ in range(2))
    scale = shape[3] ** -0.5
    ref = k1.attention_lse_plain(q, k, scale)
    rounded = k1.attention_lse_plain(q.bfloat16().float(),
                                     k.bfloat16().float(), scale)
    rms, mx = cs.lse_errs(rounded, ref)
    assert rms <= cs.LSE_RMS_TOL and mx <= cs.LSE_MAX_TOL
    rms, mx = cs.lse_errs(k1.attention_lse_plain(q, k[:, 64:], scale), ref)
    assert rms > cs.LSE_RMS_TOL


def test_chip_smoke_tiny_vae_decode_launches_no_k2(monkeypatch):
    """The cli phase's TinyVAE decode: at 768x768 the UNet launches K1 as
    the large VAE's decode does, and the TinyVAE (stock convs) launches
    neither kernel: ``TINY_VAE_PER_CALL``."""
    import chip_smoke as cs
    from onedc_tpu_torch.models.onedc import OneDC

    k1, k2 = _recorded_launches(monkeypatch)
    with torch.device("meta"):
        model = OneDC(z_only=True, use_large_vae=False)
    for bucket, want in cs.TINY_VAE_PER_CALL.items():
        h, w = map(int, bucket.split("x"))
        k1.clear()
        k2.clear()
        with torch.no_grad():
            z = torch.zeros((1, h // 64, w // 64), dtype=torch.int32,
                            device="meta")
            assert model.decode_device_z_only(z).shape == (1, 3, h, w)
        assert (sum(k1.values()), sum(k2.values())) == want, bucket


class _StubCoder:
    """A host coder that decodes zeros: the schedule's shape only."""

    @staticmethod
    def decode_streams_with_indexes(coders, indexes):
        return np.zeros(indexes.shape, np.int16)


def _stub_programs(calls):
    """Device programs of the staged decode on tiny CPU tensors, counting
    x0 calls (one K1 launch per attention layer each) and VAE calls (one
    K2 launch per resnet conv each) with their batch sizes."""
    from onedc_tpu_torch.serving.pipeline import DecodePrograms

    def state(b):
        z = torch.zeros((b, 1, 1, 4))
        return {"y_hat": z, "means": z, "common": z, "z_semantic": z,
                "indexes_r": torch.zeros((b, 1, 1, 1), dtype=torch.int32)}

    def update(yq, means, y_hat, common):
        return state(means.shape[0])

    def x0(y_hat, z_semantic):
        calls["x0"].append(y_hat.shape[0])
        return torch.zeros((y_hat.shape[0], 4, 1, 1))

    def vae(x):
        calls["vae"].append(x.shape[0])
        return torch.zeros((x.shape[0], 3, 1, 1))

    return DecodePrograms(begin=lambda z: state(z.shape[0]),
                          update=[update] * 4, x0=x0, vae=vae)


@pytest.mark.parametrize("n,chunk,vae_chunk", [
    (2, 8, 8), (18, 8, 8), (16, 8, 8), (6, 8, 8), (3, 1, 8), (3, 3, 1),
    (11, 4, 3)])
def test_chip_smoke_pipelined_tables_hold_the_schedule(n, chunk, vae_chunk):
    """chip_smoke.py's ``pipelined_launches`` holds what the pipelined
    schedule (``serving/pipeline.py``) dispatches: the schedule runs on
    stub programs that count its x0 chunks (K1 per decode each) and VAE
    sub-batches (K2 per decode each), every row decoded once."""
    import chip_smoke as cs
    from onedc_tpu_torch.serving.pipeline import pipelined_decode

    calls = {"x0": [], "vae": []}
    decs = [{"bit_stream_z": b"", "bit_stream_y": b""}] * n
    out = pipelined_decode(
        _stub_programs(calls), lambda ys: [_StubCoder()] * len(ys),
        lambda data: np.zeros(1, np.int32), decs, 1, 1, "cpu",
        chunk=chunk, depth=3, vae_chunk=vae_chunk)
    assert out.shape[0] == n
    assert sum(calls["x0"]) == sum(calls["vae"]) == n
    k1, k2 = cs.decode_launches(768, 768)
    assert cs.pipelined_launches((768, 768), n, chunk, vae_chunk) == (
        len(calls["x0"]) * k1, len(calls["vae"]) * k2)


def test_chip_smoke_serving_tables():
    """The serving phase's and the cli phase's expectations from the
    pipelined tables: the 40 serving streams (18 at 512x768 in three
    chunks, 6 at 768x512, 16 at 768x768 in two), the Kodak-sized
    ``--serving`` pass (its encode chunks added), the bundle's 16 768x768
    streams at batch 8 and its 8-image encode."""
    import chip_smoke as cs

    assert cs.batch_launches(cs.SERVE_SIZES) == (40, 168)
    assert cs.serving_launches(cs.SERVING_SIZES) == (20, 192)
    assert cs.batch_launches([(768, 768), (768, 768), (512, 768)]) == (
        15, 56)
    h, w, b = cs.BUNDLE_BUCKET
    assert cs.pipelined_launches((h, w), cs.SERVE_SQUARE, b, b) == (20, 56)
    assert cs.ENCODE_PER_CALL[(h, w)] == (2, 20)


def test_chip_smoke_w8a8_tables(monkeypatch):
    """The w8a8 phase's tables: the quantized ops per 768x768 decode by
    family at the default gate 512 (W8A8_OPS) are what the full-width
    model quantizes in a recording pass on meta tensors, with the int8
    products they make (four per upsample conv); the pipelined decode of
    the SERVE_SQUARE streams runs two x0 chunks and two VAE sub-batches,
    so twice each, and launches K1 and K2 as the exact decode does."""
    from collections import Counter

    import chip_smoke as cs
    from onedc_tpu_torch.models.onedc import OneDC
    from onedc_tpu_torch.nn import quant

    monkeypatch.delenv("ONEDC_Q8_MIN_CH", raising=False)
    monkeypatch.delenv("ONEDC_Q8_UPSAMPLE", raising=False)
    with torch.device("meta"):
        model = OneDC()
    c = model.codec.y_spatial_prior_reduction.out_channels
    s = model.codec.hyper_dec.feat_in.out_channels
    with torch.no_grad(), quant.recording() as ops, \
            quant.w8a8_scope(quant.w8a8_table(model)):
        image = model.decode_device_vae(model.decode_device_x0(
            torch.empty((1, 48, 48, c), device="meta"),
            torch.empty((1, 12, 12, s), device="meta")))
    assert image.shape == (1, 3, 768, 768)
    assert dict(Counter(o.family for o in ops)) == cs.W8A8_OPS
    assert all(min(o.cin, o.cout) >= 512 for o in ops)
    assert cs.int8_products(cs.W8A8_OPS) == len(ops) + 3 * sum(
        o.family == "upsample" for o in ops)
    assert -(-cs.SERVE_SQUARE // cs.SERVING_CHUNK) == 2
    assert cs.pipelined_launches((768, 768), cs.SERVE_SQUARE) == (20, 56)


def test_chip_smoke_trains_with_lpips(tmp_path):
    """The training phase's config: TRAIN_OVERRIDES no longer let the
    trainer go without LPIPS, and with the phase's file the stage-I config
    weighs LPIPS in the loss; the trainer builds its frozen VGG from it
    (at the tiny width on the CPU)."""
    import chip_smoke as cs
    from onedc_tpu_torch.config import load_config
    from onedc_tpu_torch.nn.lpips import random_lpips_weights
    from onedc_tpu_torch.train.trainer import Trainer
    from onedc_tpu_torch.utils.safetensors import save_safetensors
    from torch_port_common import TINY

    assert "allow_no_lpips" not in cs.TRAIN_OVERRIDES
    path = tmp_path / "lpips.safetensors"
    save_safetensors(random_lpips_weights(0), path)
    cfg = load_config(Path(cs.__file__).parent / "configs" /
                      "train_stage1.yaml", cs.train_overrides(path))
    assert cfg["lpips_weights"] == str(path) and cfg["lpips_weight"] > 0
    assert not cfg.get("allow_no_lpips")
    assert (cfg["optimizer"], cfg["frozen"], cfg["resolutions"]) == (
        "adamw", ["vae"], [512, 768])
    tr = Trainer(dict(cfg, model=dict(TINY), run_dir=str(tmp_path / "run")),
                 device="cpu")
    assert tr.lpips is not None and tr.loss.lpips_fn is not None


def test_chip_smoke_quality_tables():
    """The quality phase's launches: per image one encode and one decode,
    for each of the sweep's two points (over QUALITY_SIZES, half the
    Kodak-sized set); and the kernels line reads the phase's
    K1 and K2 launches under ``quality``."""
    import inspect

    import chip_smoke as cs

    assert cs.quality_launches(cs.SERVING_SIZES) == (240, 2304)
    assert cs.QUALITY_SIZES == cs.SERVING_SIZES[:12]
    assert cs.quality_launches(cs.QUALITY_SIZES) == (120, 1152)
    assert cs.quality_launches([(768, 768)], points=1) == (12, 48)
    source = inspect.getsource(cs.main)
    assert '"quality": quality["K1"]' in source
    assert '"quality": quality["K2"]' in source


def test_chip_smoke_quality_reference_is_the_ports_metrics():
    """The quality phase's numpy f64 PSNR / MS-SSIM (its plain reference
    for the card) against the port's f32 metrics on the CPU, on a
    landscape and a portrait image, within the phase's limits."""
    import chip_smoke as cs
    from onedc_tpu_torch.eval import metrics

    rng = np.random.default_rng(0)
    for h, w in ((192, 256), (256, 192)):
        x = np.repeat(np.repeat(rng.uniform(0, 1, (h // 8, w // 8, 3)), 8,
                                0), 8, 1)
        y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1)
        x, y = x.astype(np.float32), y.astype(np.float32)
        psnr, msssim = cs.quality_reference_f64(x, y)
        xt, yt = torch.from_numpy(x)[None], torch.from_numpy(y)[None]
        assert abs(float(metrics.psnr(xt, yt)[0]) - psnr) <= \
            cs.QUALITY_PSNR_TOL
        assert abs(float(metrics.ms_ssim(xt, yt)[0]) - msssim) <= \
            cs.QUALITY_SSIM_TOL
        assert 0.1 < msssim < 0.99


def test_chip_smoke_tiled_tables():
    """The tiled phase's plan (3 rows x 6 columns of 768x768 tiles on a
    3840x2160 image) and its launches: the encode's device chunks of
    SERVING_CHUNK tiles, the pipelined decode of the 18 streams, the
    768x768 pass-through's encode and decode."""
    import chip_smoke as cs
    from onedc_tpu_torch.parallel.tiled import plan_tiles

    corners = plan_tiles(*cs.TILED_SIZE, cs.TILED_TILE, cs.TILED_OVERLAP)
    assert len(corners) == cs.TILED_TILES == 18
    assert sorted({y for y, _ in corners}) == [0, 704, 1392]
    assert sorted({x for _, x in corners}) == [0, 704, 1408, 2112, 2816,
                                               3072]
    assert cs.tiled_launches() == {"encode": (6, 60), "decode": (30, 84),
                                   "pass_through": (12, 48)}
    assert cs.tiled_image(0).shape == (1, *cs.TILED_SIZE, 3)


def test_chip_smoke_train_loop_tables(monkeypatch):
    """The training-loop phase's launches: the steps' resolutions by
    ``MultiResolutionCrop.pick`` (768 at steps 0-2), TRAIN_PER_STEP per
    step, and
    EVAL_PER_IMAGE, which the full-width model's eval forward (no
    gradient) launches at 512x768 on meta tensors."""
    import chip_smoke as cs
    from onedc_tpu_torch.data.crops import MultiResolutionCrop
    from onedc_tpu_torch.models.onedc import OneDC

    crop = MultiResolutionCrop(cs.TRAIN_OVERRIDES["resolutions"],
                               cs.TRAIN_OVERRIDES["batch_scales"])
    assert [crop.pick(s)[0] for s in range(cs.TRAIN_LOOP_STEPS)] == \
        [768, 768, 768]
    assert cs.train_loop_launches() == (58, 48, 288, 112)
    k1, k2 = _recorded_launches(monkeypatch)
    with torch.device("meta"):
        model = OneDC()
    with torch.no_grad():
        _, pred = model(torch.zeros((1, 512, 768, 3), device="meta"))
    assert pred.shape == (1, 512, 768, 3)
    assert (sum(k1.values()), 0, sum(k2.values()), 0) == \
        cs.EVAL_PER_IMAGE[(512, 768)]


@pytest.mark.parametrize("res,batch", [(512, 8), (1024, 2)])
def test_chip_smoke_stage1_tables(monkeypatch, res, batch):
    """The stage-I yaml phase's tables: the full-width model with the
    Codeformer, in a training forward on meta tensors at each step's
    resolution and batch, gives K1 and K2 the "stage" buckets' shapes and
    counts, and its VAE decoder alone the K3 bucket's (each decoder conv's
    input gradient); with remat a step launches K1 and the decoder's K2
    again (``stage1_per_step``, held on the CPU in
    ``tests/test_torch_train_levers.py``)."""
    from collections import Counter

    import chip_smoke as cs
    from onedc_tpu_torch.models.onedc import OneDC

    bucket = f"stage{res}"
    k1, k2 = _recorded_launches(monkeypatch)
    with torch.device("meta"):
        model = OneDC(use_codeformer=True)
    image = torch.zeros((batch, res, res, 3), device="meta")
    with torch.no_grad():
        enc, pred = model(image, training=True,
                          noise=torch.zeros((batch, res // 16, res // 16,
                                             128), device="meta"))
    assert pred.shape == image.shape
    assert enc["code_ce_loss"].shape == ()
    assert dict(k1) == dict(Counter(dict(cs.K1_TRAIN_SHAPES[bucket])))
    assert dict(k2) == dict(Counter(dict(cs.K2_TRAIN_SHAPES[bucket])))
    k2.clear()
    with torch.no_grad():
        model.vae.decode(torch.zeros((batch, 4, res // 8, res // 8),
                                     device="meta"))
    k3 = Counter()
    for (b, h, w, cin, cout), n in k2.items():
        k3[(b, h, w, cout, cin)] += n
    assert dict(k3) == dict(Counter(dict(cs.K3_TRAIN_SHAPES[bucket])))
    per_forward = (sum(n for _, n in cs.K1_TRAIN_SHAPES[bucket]),
                   sum(n for _, n in cs.K1_TRAIN_SHAPES[bucket]),
                   sum(n for _, n in cs.K2_TRAIN_SHAPES[bucket]),
                   sum(k3.values()))
    assert per_forward == cs.STAGE1_PER_FORWARD[res]
    k1_fwd, k1_bwd, k2_fwd, k3_n = per_forward
    assert cs.stage1_per_step(res) == (2 * k1_fwd, k1_bwd, k2_fwd + k3_n,
                                       k3_n)


def test_chip_smoke_stage1_phase_runs_the_yaml(tmp_path):
    """The stage-I yaml phase's config: configs/train_stage1.yaml with
    STAGE1_OVERRIDES alone keeps the yaml's recipe (Adafactor, the
    Codeformer, frozen [vae, vqgan], batch 8, the Codeformer weights, remat
    by default); its steps' resolutions and launches; the earlier training
    phases run without remat, as they did before it was ported."""
    import chip_smoke as cs
    from onedc_tpu_torch.config import load_config
    from onedc_tpu_torch.data.crops import MultiResolutionCrop

    cfg = load_config(Path(cs.__file__).parent / "configs" /
                      "train_stage1.yaml", cs.STAGE1_OVERRIDES)
    assert (cfg["optimizer"], cfg["frozen"], cfg["batch_size"],
            cfg["model"]["use_codeformer"]) == (
        "adafactor", ["vae", "vqgan"], 8, True)
    assert "gradient_checkpointing" not in cfg
    assert (cfg["codeformer_loss_weight"], cfg["codeformer_mse_weight"]) \
        == (1e-3, 1e-2)
    assert sorted(cs.STAGE1_OVERRIDES) == ["batch_scales", "resolutions"]
    assert cfg["fsdp"] is True
    crop = MultiResolutionCrop(cfg["resolutions"], cfg["batch_scales"])
    picks = [crop.pick(s) for s in range(cs.STAGE1_STEPS)]
    assert [r for r, _ in picks].count(512) == 3
    assert {(r, round(8 * s)) for r, s in picks} == {(512, 8), (1024, 2)}
    assert cs.stage1_launches() == (174, 87, 684, 252)
    assert cs.TRAIN_OVERRIDES["gradient_checkpointing"] is False


def test_chip_smoke_stage2_tables(monkeypatch):
    """The stage-II phase's tables: at full width on meta tensors, a
    512x512 batch-4 generator forward and the guidance's two forwards give
    K1 and K2 the shapes of the "stage2" buckets (the real UNet's CFG rows:
    "stage512"'s K1 shape), and their counts add up to ``stage2_per_step``
    with remat's recompute; the phase runs the yaml's recipe."""
    from collections import Counter

    import chip_smoke as cs
    from onedc_tpu_torch.config import load_config
    from onedc_tpu_torch.models.dmd import SDGuidance
    from onedc_tpu_torch.models.onedc import OneDC

    k1, k2 = _recorded_launches(monkeypatch)
    b, res = 4, cs.STAGE2_SIZE
    with torch.device("meta"):
        model = OneDC()
        guidance = SDGuidance()
    image = torch.zeros((b, res, res, 3), device="meta")
    with torch.no_grad():
        x_latent, x0 = model.training_latents(image)
    latents_only = (sum(k1.values()), sum(k2.values()))
    k1.clear()
    k2.clear()
    with torch.no_grad():
        _, pred = model(image, training=True,
                        noise=torch.zeros((b, res // 16, res // 16, 128),
                                          device="meta"))
    assert pred.shape == image.shape
    forward = dict(k1), dict(k2)
    k1.clear()
    text = torch.zeros((b, 77, 768), device="meta")
    t = torch.zeros((b,), dtype=torch.int64, device="meta")
    draws = {"dm_t": t, "dm_noise": x0, "cls_t": t, "cls_noise": x0}
    with torch.no_grad():
        guidance.generator_forward(x0, text, text, draws=draws)
    gen_guidance = dict(k1)
    k1.clear()
    draws = {f"{p}_{s}": v for p in ("fake", "real_cls", "fake_cls")
             for s, v in (("t", t), ("noise", x0))}
    with torch.no_grad():
        guidance.guidance_forward(x0, x_latent, text, text, text,
                                  draws=draws)
    guid = dict(k1)

    shape, cfg_shape = (b, 4096, 8, 40), (2 * b, 4096, 8, 40)
    assert dict(cs.K1_TRAIN_SHAPES["stage2"]) == {shape: cs.STAGE2_UNET_K1}
    assert dict(cs.K1_TRAIN_SHAPES["stage512"]) == {cfg_shape: 5}
    assert forward[0] == {shape: cs.STAGE2_UNET_K1}
    assert forward[1] == dict(Counter(dict(cs.K2_TRAIN_SHAPES["stage2"])))
    assert latents_only == (cs.STAGE2_UNET_K1, cs.STAGE2_ENC_K2)
    unet, down = cs.STAGE2_UNET_K1, cs.STAGE2_DOWN_K1
    assert gen_guidance == {shape: unet + down, cfg_shape: unet}
    assert guid == {shape: unet + 2 * down}
    k3 = sum(n for _, n in cs.K3_TRAIN_SHAPES["stage2"])
    assert k3 == cs.STAGE2_DEC_K2
    assert sum(forward[1].values()) == cs.STAGE2_ENC_K2 + cs.STAGE2_DEC_K2
    g = unet + 2 * down
    assert cs.stage2_per_step(True) == (
        2 * unet + 2 * unet + down + 2 * g, unet + down + g,
        cs.STAGE2_ENC_K2 + 2 * k3, k3)
    assert cs.stage2_per_step(False) == (unet + 2 * g, g, cs.STAGE2_ENC_K2,
                                         0)
    # steps 0-2 (a generator turn at 0), eval at 2, the resumed step 2
    assert (cs.STAGE2_STEPS, cs.STAGE2_SAVE) == (3, 2)
    assert cs.stage2_launches() == tuple(
        a + 3 * b + 2 * e for a, b, e in zip(
            cs.stage2_per_step(True), cs.stage2_per_step(False),
            cs.EVAL_PER_IMAGE[(512, 512)]))

    cfg = load_config(Path(cs.__file__).parent / "configs" /
                      "train_stage2.yaml", {})
    assert (cfg["batch_size"], cfg["dfake_gen_update_ratio"]) == (4, 10)
    assert "optimizer" not in cfg and "gradient_checkpointing" not in cfg


def test_chip_smoke_spatial_tables(monkeypatch):
    """The spatial phase's tables: the full-width z-only decode split over
    SPATIAL_BANDS bands on meta tensors (a band whose collectives return
    meta tensors of the gathered shapes): at 768x768 each band launches K1
    at the "spatial768" shapes (its queries against every band's keys) and
    K2 on its rows plus one row of its neighbour, as many launches as the
    single decode; one rank of the data axis launches ``data_mesh_
    launches``: one encode of its rows and one pipelined decode."""
    from collections import Counter

    import chip_smoke as cs
    from onedc_tpu_torch.models.onedc import OneDC
    from onedc_tpu_torch.parallel import spatial

    class MetaBand(spatial.Band):
        def gather(self, x, dim):
            return torch.cat([x] * self.size, dim)

        def sum(self, t):
            return t.clone()

    k1, k2 = _recorded_launches(monkeypatch)
    with torch.device("meta"):
        model = OneDC(z_only=True)
    h, w = cs.SPATIAL_SIZE
    z = torch.zeros((1, h // 64, w // 64), dtype=torch.int32, device="meta")
    for index in range(cs.SPATIAL_BANDS):
        k1.clear()
        k2.clear()
        programs = spatial.SpatialPrograms(
            model, MetaBand(None, index, cs.SPATIAL_BANDS), True)
        with torch.no_grad():
            assert programs.z_only(z).shape == (1, 3, h, w)
        assert k1 == Counter(dict(cs.K1_SHAPES["spatial768"]))
        assert k2 == Counter(dict(cs.K2_SHAPES["spatial768"]))
        assert (sum(k1.values()), sum(k2.values())) == (
            cs.K1_PER_CALL["768x768"], cs.K2_PER_CALL["768x768"])
    assert cs.data_mesh_launches() == (
        cs.ENCODE_PER_CALL[(768, 768)][0] + cs.K1_PER_CALL["768x768"],
        cs.ENCODE_PER_CALL[(768, 768)][1] + cs.K2_PER_CALL["768x768"])
