"""The frozen counters against hand counts on small shapes."""

from __future__ import annotations

import pytest

from benchmark.harness import work
from benchmark.reference import entropy


def test_conv_bound_by_hand():
    # 1 x 8 x 8, 64 -> 64: 18 * 64 * 64 * 64 FLOPs; bytes of x, y, w, bias,
    # and the f32 (mul, add) pair
    flops = 18.0 * 1 * 8 * 8 * 64 * 64
    nbytes = 8 * 8 * 128 * 2 + 9 * 64 * 64 * 2 + 2 * 64 * 4 + 64 * 2
    assert work.conv_bound(1, 8, 8, 64, 64, 2) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12))


def test_attention_bound_by_hand():
    b, n, h, d, m = 2, 4096, 8, 40, 4096
    flops = 4.0 * b * h * n * m * d
    nbytes = 2 * b * (n + m) * h * d * 2
    exps = b * h * n * m
    assert work.attention_bound(b, n, h, d, m, 2) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12, exps / (132 * 16 * 1.83e9)))
    assert work.flash_route(6144, 6144)
    assert not work.flash_route(1536, 1536) and not work.flash_route(6144, 96)


def test_decode_work_counts_the_nets_and_the_kernel_shapes():
    model = dict(internal_ch=64, bottleneck_ch=32, unet_ch_config=[32, 64, 64],
                 ctrl_ch=32, sd_block_channels=[32, 32, 64, 64],
                 context_dim=64, vae_block_channels=[64, 64, 64, 64],
                 vae_attn_patch=4)
    w = work.decode_work(model, 256, 384, z_only=False)
    # the VAE decoder's 15 resnet blocks: two K2 convs each
    vae = 0.0
    for hh, ww, n in ((32, 48, 2 + 3), (64, 96, 3), (128, 192, 3),
                      (256, 384, 3)):
        vae += n * 2 * work.conv_bound(1, hh, ww, 64, 64, 2)
    assert w["k2_bound_s"] == pytest.approx(vae)
    # UNet self-attention at 32 x 48 = 1536 tokens: below the flash rule
    assert w["k1_bound_s"] == 0.0
    assert w["flops"] > 2 * 18 * 256 * 384 * 64 * 64
    assert w == work.decode_work(model, 256, 384, z_only=False)


def test_index_packing_and_scale_buckets():
    import numpy as np
    import torch

    z = np.arange(12).reshape(1, 3, 4) * 1000
    data = entropy.pack_indices(z)
    assert len(data) == (12 * 14 + 7) // 8
    assert (entropy.unpack_indices(data, 12).reshape(1, 3, 4) == z).all()
    idx = entropy.scale_indexes(torch.tensor([0.0, 0.11, 1.0, 64.0, 1e3]))
    assert idx.tolist()[0] == 0 and idx.tolist()[-1] == 255
    assert idx.tolist() == sorted(idx.tolist())
