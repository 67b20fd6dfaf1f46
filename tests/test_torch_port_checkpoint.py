"""The port loads the reference's released checkpoints without JAX
(``onedc_tpu_torch/utils/port_torch.py``, ``utils/safetensors.py``,
``utils/convert.py:state_dict_from_safetensors``), held against the JAX
porter on the same files at the tiny geometry of
``tests/test_inference_cli.py``, and on the full layout for names and
shapes.
"""

import warnings

import numpy as np
import pytest
import torch
from torch_port_common import one_torch_thread, tiny_jax_model  # noqa: F401

import twins
from onedc_tpu.utils.checkpoint import save_safetensors as jax_save
from onedc_tpu.utils.port_torch import \
    port_onedc_checkpoint as jax_port_onedc_checkpoint
from onedc_tpu_torch.models.onedc import OneDC
from onedc_tpu_torch.utils.convert import (
    state_dict_from_jax,
    state_dict_from_safetensors,
)
from onedc_tpu_torch.utils import port_torch
from onedc_tpu_torch.utils.port_torch import port_onedc_checkpoint
from onedc_tpu_torch.utils.safetensors import (
    DTYPES,
    SafetensorsWriter,
    load_safetensors,
    save_safetensors,
)

TINY_MODEL = dict(
    internal_ch=64, bottleneck_ch=32, unet_ch_config=[32, 64, 64],
    ctrl_ch=32, sd_block_channels=[32, 32, 64, 64], context_dim=64,
    vae_block_channels=[32, 32, 64, 64], vae_attn_patch=4,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _vae_resnet(b, p: str, in_ch: int, out_ch: int):
    """diffusers ResnetBlock2D of the VAE (no time embedding)."""
    b.norm(f"{p}.norm1", in_ch)
    b.conv(f"{p}.conv1", out_ch, in_ch)
    b.norm(f"{p}.norm2", out_ch)
    b.conv(f"{p}.conv2", out_ch, out_ch)
    if in_ch != out_ch:
        b.conv(f"{p}.conv_shortcut", out_ch, in_ch, k=1)


def _vae_mid(b, p: str, ch: int):
    """UNetMidBlock2D: resnet, Attention (group_norm, biased to_q / to_k /
    to_v / to_out.0 linears), resnet."""
    _vae_resnet(b, f"{p}.resnets.0", ch, ch)
    b.norm(f"{p}.attentions.0.group_norm", ch)
    for m in ("to_q", "to_k", "to_v", "to_out.0"):
        b.linear(f"{p}.attentions.0.{m}", ch, ch)
    _vae_resnet(b, f"{p}.resnets.1", ch, ch)


def vae_twin(seed: int = 2, block_channels=(128, 256, 512, 512),
             latent_ch: int = 4, layers_per_block: int = 2):
    """A diffusers ``AutoencoderKL`` state dict (SD2.1 layout): encoder
    DownEncoderBlock2D x4, decoder UpDecoderBlock2D x4 (one more resnet
    per block), quant_conv / post_quant_conv 1x1."""
    b = twins._Builder(seed)
    ch = list(block_channels)
    b.conv("encoder.conv_in", ch[0], 3)
    prev = ch[0]
    for i, c in enumerate(ch):
        for j in range(layers_per_block):
            _vae_resnet(b, f"encoder.down_blocks.{i}.resnets.{j}",
                        prev if j == 0 else c, c)
        if i < len(ch) - 1:
            b.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c)
        prev = c
    _vae_mid(b, "encoder.mid_block", ch[-1])
    b.norm("encoder.conv_norm_out", ch[-1])
    b.conv("encoder.conv_out", 2 * latent_ch, ch[-1])
    b.conv("quant_conv", 2 * latent_ch, 2 * latent_ch, k=1)

    rev = ch[::-1]
    b.conv("post_quant_conv", latent_ch, latent_ch, k=1)
    b.conv("decoder.conv_in", rev[0], latent_ch)
    _vae_mid(b, "decoder.mid_block", rev[0])
    prev = rev[0]
    for i, c in enumerate(rev):
        for j in range(layers_per_block + 1):
            _vae_resnet(b, f"decoder.up_blocks.{i}.resnets.{j}",
                        prev if j == 0 else c, c)
        if i < len(rev) - 1:
            b.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c)
        prev = c
    b.norm("decoder.conv_norm_out", rev[-1])
    b.conv("decoder.conv_out", 3, rev[-1])
    return b.out


def tiny_twins():
    m = TINY_MODEL
    return (twins.sd_unet_twin(in_ch=m["ctrl_ch"],
                               block_channels=m["sd_block_channels"],
                               context_dim=m["context_dim"]),
            twins.codec_twin(ctrl_ch=m["ctrl_ch"],
                             internal_ch=m["internal_ch"],
                             bottleneck_ch=m["bottleneck_ch"],
                             unet_ch_config=m["unet_ch_config"]),
            vae_twin(block_channels=m["vae_block_channels"]))


def test_port_matches_the_jax_porter_bit_for_bit(tmp_path):
    """Reference-layout files (written by the port's writer) -> the port's
    state dict equals the JAX porter's tree through ``state_dict_from_jax``
    bit for bit, key for key; it loads with ``strict=True``."""
    paths = []
    for name, sd in zip(("model", "model_1", "vae"), tiny_twins()):
        paths.append(tmp_path / f"{name}.safetensors")
        save_safetensors(sd, paths[-1])
    unet, codec, vae = (str(p) for p in paths)
    complete = ("unet", "codec", "vae")
    want = state_dict_from_jax(jax_port_onedc_checkpoint(
        unet_path=unet, codec_path=codec, vae_path=vae,
        reference_params=tiny_jax_model()[1], require_complete=complete))
    model = OneDC(**TINY_MODEL)
    got = port_onedc_checkpoint(unet_path=unet, codec_path=codec,
                                vae_path=vae, reference=model.state_dict(),
                                require_complete=complete)
    assert sorted(got) == sorted(want)
    differ = [k for k in want if not (got[k].dtype == torch.float32
                                      and torch.equal(got[k], want[k]))]
    assert differ == []
    model.load_state_dict(got, strict=True)
    # a LoRA target really was merged (not the base weight as is)
    base = load_safetensors(unet)[
        "down_blocks.0.resnets.0.conv1.base_layer.weight"]
    assert not torch.equal(got["unet.down_blocks_0.resnets_0.conv1.weight"],
                           base)


def test_full_layout_twins_cover_the_full_model(monkeypatch):
    """The full-width UNet and codec twins (zero-stride arrays: names and
    shapes only) fill every key of the full-width ``OneDC`` under unet
    and codec with its shape; the model is built on the meta device."""
    zero = np.zeros(1, np.float32)

    def stride0(self, *shape):
        return np.lib.stride_tricks.as_strided(zero, shape, (0,) * len(shape))
    monkeypatch.setattr(twins._Builder, "_w", stride0)
    # the LoRA merge's names run as they are, its arithmetic (held bit for
    # bit against JAX's above) is left out: the base weight stands
    monkeypatch.setattr(port_torch, "_merge_one", lambda w, a, b, scale: w)
    unet, codec = twins.sd_unet_twin(), twins.codec_twin()
    assert any(k.endswith("attn1.to_q.lora_A.default.weight") for k in unet)
    with torch.device("meta"):
        reference = OneDC().state_dict()
    got = port_onedc_checkpoint(unet_path=unet, codec_path=codec,
                                reference=reference,
                                require_complete=("unet", "codec"))
    filled = [k for k in got if not got[k].is_meta]
    assert sorted(filled) == sorted(
        k for k in reference if k.split(".")[0] in ("unet", "codec"))
    assert all(got[k].shape == reference[k].shape for k in filled)


@pytest.mark.parametrize("fault", ["unmatched", "shape", "incomplete"])
def test_porter_raises_on_drift(fault):
    unet, codec, _ = tiny_twins()
    model = OneDC(**TINY_MODEL)
    kwargs = dict(unet_path=unet, codec_path=codec,
                  reference=model.state_dict())
    if fault == "unmatched":
        codec["enc.pix_emb_striped.weight"] = codec.pop("enc.pix_emb.weight")
        with pytest.raises(KeyError, match="no home"):
            port_onedc_checkpoint(**kwargs)
    elif fault == "shape":
        codec["enc.pix_emb.weight"] = codec["enc.pix_emb.weight"][:, :2]
        with pytest.raises(ValueError, match="shape mismatch"):
            port_onedc_checkpoint(**kwargs)
    else:
        del unet["conv_out.bias"]
        with pytest.raises(KeyError, match="does not cover 1 model tensors"):
            port_onedc_checkpoint(**kwargs, require_complete=("unet",))


@pytest.mark.parametrize("prefixed", [True, False])
def test_ckpt_flavour_equals_state_dict_from_jax(tmp_path, prefixed):
    """The CLI's ``ckpt=`` file (JAX ``save_safetensors`` of a param tree,
    with or without the top ``params``) reads as ``state_dict_from_jax``
    of the tree."""
    params = tiny_jax_model()[1]
    path = tmp_path / "ckpt.safetensors"
    jax_save(params if prefixed else params["params"], path)
    got = state_dict_from_safetensors(path)
    want = state_dict_from_jax(params)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_safetensors_round_trip_against_the_package(tmp_path, name):
    """Every dtype the port reads and writes, both ways against the
    ``safetensors`` package (``safetensors.torch`` for BF16, which numpy
    lacks), empty and odd-sized tensors included."""
    st_numpy = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(0)
    dtype = DTYPES[name]
    tensors = {}
    for i, shape in enumerate([(3, 5), (7,), (0, 4), (2, 1, 3)]):
        t = torch.from_numpy(rng.standard_normal(shape) * 50)
        tensors[f"t{i}"] = t > 0 if dtype == torch.bool else t.to(dtype)
    if name == "BF16":
        st = pytest.importorskip("safetensors.torch")
        save, load = st.save_file, st.load_file
        theirs = tensors
    else:
        save, load = st_numpy.save_file, st_numpy.load_file
        theirs = {k: v.numpy() for k, v in tensors.items()}

    ours = tmp_path / "ours.safetensors"
    save_safetensors(tensors, ours)
    back = load(str(ours))
    assert sorted(back) == sorted(tensors)
    for k, v in tensors.items():
        got = back[k] if name == "BF16" else torch.from_numpy(back[k])
        assert got.dtype == v.dtype and torch.equal(got, v)

    other = tmp_path / "theirs.safetensors"
    save(theirs, str(other))
    back = load_safetensors(other)
    assert sorted(back) == sorted(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v)


def test_unknown_dtype_and_bad_offsets_raise(tmp_path):
    path = tmp_path / "x.safetensors"
    save_safetensors({"a": np.zeros(4, np.float32)}, path)
    raw = bytearray(path.read_bytes())
    bad = raw.replace(b'"F32"', b'"F8X"')
    path.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="'a' has dtype 'F8X'"):
        load_safetensors(path)
    path.write_bytes(bytes(raw.replace(b"[0,16]", b"[0,99]")))
    with pytest.raises(ValueError, match="'a'.*does not fit"):
        load_safetensors(path)
    with pytest.raises(ValueError, match="cannot hold"):
        save_safetensors({"c": torch.zeros(2, dtype=torch.complex64)}, path)


def test_writer_takes_tensors_in_name_order(tmp_path):
    """``SafetensorsWriter`` writes the file ``save_safetensors`` writes,
    tensor by tensor in name order, and raises for a tensor out of order
    or one left unwritten."""
    tensors = {"b": torch.arange(6.0).reshape(2, 3),
               "a": torch.ones(4, dtype=torch.bfloat16)}
    save_safetensors(tensors, tmp_path / "whole.st", {"k": "v"})
    with SafetensorsWriter(tensors, tmp_path / "each.st", {"k": "v"}) as w:
        assert w.names == ["a", "b"]
        for name in w.names:
            w.write(name, tensors[name])
    assert ((tmp_path / "each.st").read_bytes()
            == (tmp_path / "whole.st").read_bytes())
    with pytest.raises(ValueError, match="'b' written where 'a' is next"):
        with SafetensorsWriter(tensors, tmp_path / "x.st") as w:
            w.write("b", tensors["b"])
    with pytest.raises(ValueError, match="'b' and after it never written"):
        with SafetensorsWriter(tensors, tmp_path / "x.st") as w:
            w.write("a", tensors["a"])


def test_read_only_buffers_load_without_a_warning(tmp_path):
    """``state_dict_from_jax`` of read-only arrays (as ``np.asarray`` of a
    JAX array gives) and ``load_safetensors`` raise no warning; the
    tensors own writable memory."""
    params = tiny_jax_model()[1]
    frozen = {"params": {"unet": {"conv_out": {}}}}
    for leaf, arr in params["params"]["unet"]["conv_out"].items():
        arr = np.array(arr)
        arr.setflags(write=False)
        frozen["params"]["unet"]["conv_out"][leaf] = arr
    save_safetensors({"a": np.ones(3, np.float32)}, tmp_path / "a.st")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sd = state_dict_from_jax(frozen)
        loaded = load_safetensors(tmp_path / "a.st")
    for t in list(sd.values()) + list(loaded.values()):
        t.add_(1)  # writable: no UB, and the file is untouched
    assert torch.equal(load_safetensors(tmp_path / "a.st")["a"],
                       torch.ones(3))
