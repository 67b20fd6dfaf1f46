"""Stage II's text encoder and weights in the port against the JAX package
and transformers on the CPU: the CLIP text transformer against
``FlaxCLIPTextModel`` (a tiny config: hidden 32, 2 layers; 1e-5 relative),
the hash tokenizer against JAX ``TextEncoder.tokenize``, the BPE against
``CLIPTokenizerFast`` on a small vocabulary, a local ``text_encoder/``
directory, and the guidance porter and ``convert_weights guidance``
against the JAX porter on ``tests/twins.py:guidance_twin``, bit for bit,
with ``strict=True`` loads of the guidance and CLIP trees."""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_common import one_torch_thread  # noqa: E402,F401
from twins import guidance_twin  # noqa: E402

from onedc_tpu_torch.nn import text_encoder as pte  # noqa: E402
from onedc_tpu_torch.utils.convert import (  # noqa: E402
    clip_state_dict_from_flax, convert_leaf, state_dict_from_jax)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY_CLIP = dict(vocab_size=600, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=2, num_attention_heads=4,
                 max_position_embeddings=77, hidden_act="quick_gelu",
                 layer_norm_eps=1e-5)
GUIDANCE = dict(block_channels=(32, 32, 64, 64), context_dim=32)


@pytest.fixture(scope="module")
def flax_clip():
    """(FlaxCLIPTextModel, seeded params, ids, last hidden state)."""
    from transformers import CLIPTextConfig, FlaxCLIPTextModel
    model = FlaxCLIPTextModel(CLIPTextConfig(**TINY_CLIP), _do_init=False)
    shapes = jax.eval_shape(lambda: model.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32),
        jnp.ones((1, 77), jnp.int32), jnp.arange(77)[None]))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape))
                          .astype(np.float32), shapes)
    ids = rng.integers(0, TINY_CLIP["vocab_size"], (2, 77)).astype(np.int32)
    out = model(input_ids=ids, params=params["params"]).last_hidden_state
    return params, ids, np.asarray(out)


def test_clip_text_model_matches_flax(flax_clip):
    params, ids, want = flax_clip
    model = pte.CLIPTextModel(**TINY_CLIP)
    model.load_state_dict(clip_state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long()).numpy()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_hash_tokenizer_is_the_jax_rule():
    from onedc_tpu.nn.text_encoder import TextEncoder as JaxTextEncoder
    caps = ["", "a photo of a cat", "", "x" * 300]
    jax_self = SimpleNamespace(tokenizer=None, max_length=77)
    want = JaxTextEncoder.tokenize(jax_self, caps)
    enc = pte.TextEncoder(device="cpu", config=TINY_CLIP)
    got = enc.tokenize(caps)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # hash("") == 0: the image folders' empty captions are one fixed row
    np.testing.assert_array_equal(got[0, :3], [49406, 0, 49407])


def _vocab_dir(path):
    """A small CLIP vocabulary: every byte character with and without
    ``</w>``, a few merges, the two special tokens."""
    chars = list(pte.bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"),
              ("c", "a"), ("ca", "t</w>"), ("o", "n</w>"), ("r", "e"),
              ("d", "o"), ("g", "</w>"), ("'", "s</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    for tok in ("</w>", "<|startoftext|>", "<|endoftext|>"):
        vocab[tok] = len(vocab)
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return path


CAPTIONS = ["", "The cat and the dog on a mat!", "A CAT's 2 dogs_on re-do...",
            "naïve café 東京 ½ — ok\tthe\n", "  spaced   out  ", "x" * 100,
            "<|startoftext|>hi<|endoftext|>", "it'll've 42nd"]


def test_bpe_tokenizer_matches_clip_tokenizer_fast(tmp_path):
    from transformers import CLIPTokenizerFast
    d = _vocab_dir(tmp_path / "tok")
    fast = CLIPTokenizerFast(str(d / "vocab.json"), str(d / "merges.txt"))
    want = fast(CAPTIONS, padding="max_length", max_length=77,
                truncation=True, return_tensors="np")["input_ids"]
    got = pte.CLIPBPETokenizer.from_dir(d)(CAPTIONS)
    np.testing.assert_array_equal(got, want)


def test_text_encoder_reads_a_local_sd15_directory(tmp_path):
    """``text_encoder/`` with ``config.json`` and ``model.safetensors``
    (transformers' names, a ``position_ids`` buffer as older files carry
    it), the tokenizer in the sibling ``tokenizer/``; the weights load
    strictly and encode as the module they came from."""
    from onedc_tpu_torch.utils.safetensors import save_safetensors
    _vocab_dir(tmp_path / "tokenizer")
    te = tmp_path / "text_encoder"
    te.mkdir()
    cfg = dict(TINY_CLIP, vocab_size=len(json.loads(
        (tmp_path / "tokenizer" / "vocab.json").read_text())))
    (te / "config.json").write_text(json.dumps(cfg))
    src = pte.CLIPTextModel(**cfg)
    pte.init_clip_weights(src, torch.Generator().manual_seed(4))
    state = dict(src.state_dict())
    state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    save_safetensors(state, te / "model.safetensors")

    enc = pte.TextEncoder(str(te), device="cpu")
    ids = enc.tokenize(["the cat", ""])
    assert ids[0, 0] == ids[1, 0] and ids[1, 1] == ids[1, 2]
    with torch.no_grad():
        want = src(torch.from_numpy(ids).long())
    assert torch.equal(enc.encode(ids), want)
    assert enc.uncond_embedding(3).shape == (3, 77, 32)


def test_a_directory_without_a_tokenizer_raises(tmp_path):
    (tmp_path / "text_encoder").mkdir()
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        pte.TextEncoder(str(tmp_path / "text_encoder"), device="cpu")


# -- the guidance weights -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_guidance_shapes():
    from onedc_tpu.models.dmd import SDGuidance
    g = SDGuidance(**GUIDANCE)
    lat = jnp.zeros((1, 8, 8, 4), jnp.float32)
    ctx = jnp.zeros((1, 7, 32), jnp.float32)
    return jax.eval_shape(lambda: g.init(
        {"params": jax.random.PRNGKey(0)}, lat, ctx, ctx,
        jax.random.PRNGKey(1), method=g.generator_forward))


@pytest.mark.parametrize("with_real", [True, False])
def test_guidance_porter_is_the_jax_porter(with_real, jax_guidance_shapes,
                                           tmp_path):
    from onedc_tpu.utils import port_torch as jport
    from onedc_tpu_torch.models.dmd import SDGuidance
    from onedc_tpu_torch.utils import port_torch as pport
    from onedc_tpu_torch.utils.convert import state_dict_from_safetensors
    from onedc_tpu_torch.utils.convert_weights import main as convert_main
    from onedc_tpu_torch.utils.safetensors import save_safetensors

    twin = guidance_twin(block_channels=GUIDANCE["block_channels"],
                         context_dim=32, with_real=with_real)
    # the JAX porter's flat tree in flax layout, carried across leaf by leaf
    want = dict(convert_leaf(k, v)
                for k, v in jport.port_guidance_state(twin).items())
    got = pport.port_guidance_state(twin)
    assert sorted(got) == sorted(want)
    assert [k for k in want if not np.array_equal(got[k], want[k])] == []

    # the warm start over the JAX tree and over the port's module
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         jax_guidance_shapes)
    jax_state = state_dict_from_jax(jport.port_guidance_checkpoint(
        twin, zeros))
    with torch.device("meta"):
        module = SDGuidance(**GUIDANCE)
    state = pport.port_guidance_checkpoint(twin, module.state_dict())
    filled = {k: v for k, v in state.items() if not v.is_meta}
    assert len(filled) == len(want)
    assert all(torch.equal(filled[k], jax_state[k]) for k in filled)
    if with_real:
        module.load_state_dict(state, strict=True, assign=True)
    else:
        assert not any(k.startswith("real_unet.") for k in filled)

    # convert_weights guidance writes the JAX tree's layout
    src = tmp_path / "model_2.safetensors"
    save_safetensors(twin, src)
    out = tmp_path / "guidance.safetensors"
    convert_main(["guidance", "--src", str(src), "--out", str(out),
                  "guidance.block_channels=[32,32,64,64]",
                  "guidance.context_dim=32"])
    written = state_dict_from_safetensors(out)
    assert sorted(written) == sorted(filled)
    assert all(torch.equal(written[k], filled[k]) for k in written)


def test_the_jax_guidance_tree_loads_strictly(jax_guidance_shapes):
    from onedc_tpu_torch.models.dmd import SDGuidance
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape)
                          .astype(np.float32), jax_guidance_shapes)
    with torch.device("meta"):
        module = SDGuidance(**GUIDANCE)
    state = state_dict_from_jax(params)
    module.load_state_dict(state, strict=True, assign=True)
    conv = params["params"]["cls_pred_branch"]["conv0"]["kernel"]
    assert torch.equal(module.cls_pred_branch.conv0.weight,
                       torch.from_numpy(conv.transpose(3, 2, 0, 1).copy()))
