"""What a run makes from its seed is the same for the same seed, and other
for another; the traffic's calls are the mix it states."""

from __future__ import annotations

import torch

from benchmark.harness import decode, seeded

TRAFFIC = {"call": [[512, 768, 18], [768, 512, 6]], "pool_calls": 4}


def test_calls_are_the_mix_in_a_seeded_order():
    a = decode.calls_of(TRAFFIC, 2 ** 31 + 12345)
    assert a == decode.calls_of(TRAFFIC, 2 ** 31 + 12345)
    assert a != decode.calls_of(TRAFFIC, 7)
    assert len(a) == 4
    for call in a:
        assert sorted(call) == sorted([(512, 768)] * 18 + [(768, 512)] * 6)


def test_weights_images_and_indices_repeat_by_seed():
    shapes = [("codec.y_prior_fusion.block0.dc.conv2.weight", (8, 4, 1, 1)),
              ("unet.conv_in.bias", (8,)), ("vae.norm.weight", (8,)),
              ("unet.conv_in.weight", (8, 4, 3, 3))]
    big = 2 ** 40 + 3
    w1 = seeded.weights(shapes, big, "cpu", torch.float32, 0.1)
    w2 = seeded.weights(shapes[::-1], big, "cpu", torch.float32, 0.1)
    w3 = seeded.weights(shapes, big + 1, "cpu", torch.float32, 0.1)
    for k in w1:
        assert torch.equal(w1[k], w2[k]) and not torch.equal(w1[k], w3[k])
    assert abs(w1["vae.norm.weight"].mean() - 1) < 0.2
    assert seeded.calibration_head(
        "codec.y_prior_fusion.block0.dc.conv2.weight")
    assert not seeded.calibration_head("unet.conv_in.weight")
    i1 = seeded.images(5, [(64, 96)], "cpu")[0]
    assert torch.equal(i1, seeded.images(5, [(64, 96)], "cpu")[0])
    assert i1.shape == (1, 64, 96, 3) and i1.abs().max() <= 1
    z = seeded.z_only_indices(5, [(512, 768)], 4 ** 7)[0]
    assert z.shape == (1, 8, 12) and 0 <= z.min() and z.max() < 4 ** 7
    assert (z == seeded.z_only_indices(5, [(512, 768)], 4 ** 7)[0]).all()
