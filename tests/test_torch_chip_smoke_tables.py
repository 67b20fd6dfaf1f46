"""chip_smoke.py's tables of kernel shapes and launches, held against
what the full-width model's structure launches (on meta tensors), and its
limits on K1's row log-sum-exp (moved out of
``test_torch_train_step.py``, whose module fixture runs the JAX step for
minutes, so that these run on another worker)."""

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

    def attend(q, k, v, scale=None):  # (B, N, H, D)
        if attention.can_flash(q.shape[1], k.shape[1]):
            k1[tuple(q.shape)] += 1
        return torch.empty_like(q)

    def attend_bhnd(q, k, v, scale=None):  # (B, H, N, D)
        attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
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
