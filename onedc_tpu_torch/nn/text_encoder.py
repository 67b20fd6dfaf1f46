"""CLIP text encoder for stage II: captions condition the guidance UNets
only, never the codec.

JAX counterpart: ``onedc_tpu/nn/text_encoder.py`` (``SD15_TEXT_CONFIG``
:22, ``TextEncoder`` :34 with ``tokenize`` :51, ``encode`` :66,
``uncond_embedding`` :70), which runs transformers' ``FlaxCLIPTextModel``.
The card's machine has no ``transformers``, so the CLIP ViT-L/14 text
transformer is written here: learned token and position embeddings,
pre-LayerNorm blocks (eps 1e-5) with causal self-attention and a
``quick_gelu`` MLP, the final LayerNorm, the last hidden state out. The
module names are transformers' (``text_model.embeddings.token_embedding``,
``text_model.encoder.layers.N.self_attn.q_proj``, ...), so an SD1.5
``text_encoder/model.safetensors`` loads as it is.

With no ``pretrained_path`` the encoder has seeded random weights and the
JAX package's hash tokenizer: BOS, ``abs(hash(caption)) % 49000``, EOS,
then zeros. ``hash`` of a non-empty string depends on ``PYTHONHASHSEED``,
in JAX as here (``ROADMAP.md``, Queue 3); ``hash("") == 0``, and the image
folders' captions are ``""``. With a local SD1.5 ``text_encoder/``
directory the weights come from its ``model.safetensors`` (read by
``utils/safetensors.py``) and the captions go through CLIP's byte-level
BPE from ``vocab.json`` + ``merges.txt``, in the directory or in its
sibling ``tokenizer/``; a directory without them raises. The BPE follows
transformers' ``CLIPTokenizerFast``, which the JAX package loads: its
normalizer (NFC, white space, lower case), its pre-tokenizer pattern
scanned by Unicode category (``split_words``), the byte-level merges.
"""

from __future__ import annotations

import json
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.logging import get_logger

log = get_logger("onedc_tpu_torch.text")

SD15_TEXT_CONFIG = dict(
    vocab_size=49408,
    hidden_size=768,
    intermediate_size=3072,
    num_hidden_layers=12,
    num_attention_heads=12,
    max_position_embeddings=77,
    hidden_act="quick_gelu",
    layer_norm_eps=1e-5,
)

BOS_ID = 49406
EOS_ID = 49407


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape

        def split(t):
            return t.view(b, n, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), \
            split(self.v_proj(x))
        scores = (q * self.head_dim ** -0.5) @ k.transpose(-1, -2)
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        # flax adds the dtype's lowest value where the mask is off
        scores = scores.float().masked_fill(~causal,
                                            torch.finfo(torch.float32).min)
        out = scores.softmax(-1).to(v.dtype) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, n, d))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.mlp = CLIPMLP(dim, hidden)
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, n_layers: int,
                 eps: float):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(dim, heads, hidden, eps) for _ in range(n_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class CLIPEmbeddings(nn.Module):
    def __init__(self, vocab: int, dim: int, positions: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, dim)
        self.position_embedding = nn.Embedding(positions, dim)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


class CLIPTextTransformer(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int,
                 intermediate_size: int, num_hidden_layers: int,
                 num_attention_heads: int, max_position_embeddings: int,
                 layer_norm_eps: float, hidden_act: str = "quick_gelu"):
        super().__init__()
        if hidden_act != "quick_gelu":
            raise ValueError(f"hidden_act {hidden_act!r}: only quick_gelu "
                             f"(SD1.5's CLIP) is written")
        self.embeddings = CLIPEmbeddings(vocab_size, hidden_size,
                                         max_position_embeddings)
        self.encoder = CLIPEncoder(hidden_size, num_attention_heads,
                                   intermediate_size, num_hidden_layers,
                                   layer_norm_eps)
        self.final_layer_norm = nn.LayerNorm(hidden_size,
                                             eps=layer_norm_eps)

    def forward(self, ids):
        return self.final_layer_norm(self.encoder(self.embeddings(ids)))


class CLIPTextModel(nn.Module):
    """ids (B, T) int -> the last hidden state (B, T, hidden)."""

    def __init__(self, **config):
        super().__init__()
        cfg = {**SD15_TEXT_CONFIG, **config}
        self.text_model = CLIPTextTransformer(**{
            k: cfg[k] for k in SD15_TEXT_CONFIG})

    def forward(self, ids):
        return self.text_model(ids)


@torch.no_grad()
def init_clip_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights in parameter order: embeddings and linear weights
    N(0, 0.02²), biases 0, LayerNorms 1 and 0."""
    for name, p in model.named_parameters():
        if ".layer_norm" in name or "final_layer_norm" in name:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                       device=generator.device))


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------

def hash_tokenize(captions: Sequence[str], max_length: int = 77
                  ) -> np.ndarray:
    """The JAX package's tokenizer without a vocabulary (:51-62)."""
    ids = np.zeros((len(captions), max_length), np.int32)
    for i, c in enumerate(captions):
        ids[i, 0] = BOS_ID
        ids[i, 1] = abs(hash(c)) % 49000
        ids[i, 2] = EOS_ID
    return ids


@lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _kind(ch: str) -> str:
    """"L" for a letter, "N" for a number, " " for white space, else "P"."""
    if ch.isspace():
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "P"


def split_words(text: str) -> List[str]:
    """CLIP's pre-tokenizer pattern ``<|startoftext|>|<|endoftext|>|'s|'t|
    're|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (case
    blind), scanned by Unicode category."""
    out, i, n = [], 0, len(text)
    while i < n:
        for word in _SPECIALS + _CONTRACTIONS:
            if text[i:i + len(word)].lower() == word:
                out.append(text[i:i + len(word)])
                i += len(word)
                break
        else:
            kind = _kind(text[i])
            if kind == " ":
                i += 1
                continue
            j = i + 1
            if kind != "N":
                while j < n and _kind(text[j]) == kind:
                    j += 1
            out.append(text[i:j])
            i = j
    return out


# merges.txt's first line is a version header; transformers reads the
# next 49152 - 256 - 2 lines
_N_MERGES = 49152 - 256 - 2


def _clean(text: str) -> str:
    """``CLIPTokenizerFast``'s normalizer: NFC, each run of white space one
    space, lower case."""
    return re.sub(r"\s+", " ", unicodedata.normalize("NFC", text)).lower()


class CLIPBPETokenizer:
    """CLIP's byte-level BPE from ``vocab.json`` and ``merges.txt``:
    ``__call__(captions)`` -> (B, max_length) int32, BOS + at most
    max_length - 2 tokens + EOS, padded with the pad token."""

    def __init__(self, vocab: Dict[str, int], merges: List[str],
                 max_length: int = 77, pad_token: str = "<|endoftext|>"):
        self.encoder = vocab
        self.ranks = {tuple(m.split()): i
                      for i, m in enumerate(merges[:_N_MERGES])}
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos = vocab["<|startoftext|>"]
        self.eos = vocab["<|endoftext|>"]
        self.pad = vocab[pad_token]
        self.cache = {"<|startoftext|>": ["<|startoftext|>"],
                      "<|endoftext|>": ["<|endoftext|>"]}

    @classmethod
    def from_dir(cls, path, max_length: int = 77) -> "CLIPBPETokenizer":
        """From a directory holding ``vocab.json`` and ``merges.txt`` (or
        whose sibling ``tokenizer/`` holds them, the SD1.5 layout)."""
        path = Path(path)
        for d in (path, path.parent / "tokenizer"):
            if (d / "vocab.json").is_file() and (d / "merges.txt").is_file():
                break
        else:
            raise FileNotFoundError(
                f"no CLIP tokenizer (vocab.json + merges.txt) in {path} or "
                f"{path.parent / 'tokenizer'}")
        vocab = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
        merges = (d / "merges.txt").read_text(encoding="utf-8") \
            .strip().split("\n")[1:]
        pad = "<|endoftext|>"
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            f = d / name
            if f.is_file():
                tok = json.loads(f.read_text(encoding="utf-8")) \
                    .get("pad_token")
                if isinstance(tok, dict):
                    tok = tok.get("content")
                if tok:
                    pad = tok
                    break
        return cls(vocab, merges, max_length, pad)

    def bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids = []
        for token in split_words(_clean(text)):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token))
        return ids

    def __call__(self, captions: Sequence[str]) -> np.ndarray:
        out = np.full((len(captions), self.max_length), self.pad, np.int32)
        for i, c in enumerate(captions):
            ids = [self.bos] + self.encode(c)[:self.max_length - 2] \
                + [self.eos]
            out[i, :len(ids)] = ids
        return out


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

class TextEncoder:
    """Tokenizer + CLIP text model, SD1.5 layout, on ``device`` (the card
    unless the caller names another)."""

    def __init__(self, pretrained_path: Optional[str] = None,
                 max_length: int = 77, seed: int = 0, device=None,
                 config: Optional[dict] = None):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.max_length = max_length
        cfg = dict(config or {})
        if pretrained_path:
            path = Path(pretrained_path)
            self.tokenizer = CLIPBPETokenizer.from_dir(path, max_length)
            if (path / "config.json").is_file():
                on_disk = json.loads((path / "config.json").read_text())
                cfg.update({k: on_disk[k] for k in SD15_TEXT_CONFIG
                            if k in on_disk})
            with torch.device("meta"):
                model = CLIPTextModel(**cfg)
            from ..utils.safetensors import load_safetensors
            state = {k: v for k, v in load_safetensors(
                path / "model.safetensors").items()
                if not k.endswith("position_ids")}
            model.load_state_dict({k: v.float() for k, v in state.items()},
                                  strict=True, assign=True)
        else:
            log.warning("TextEncoder: random init (no pretrained_path); "
                        "captions carry no semantic signal")
            self.tokenizer = None
            model = CLIPTextModel(**cfg)
            gen = torch.Generator().manual_seed(seed)
            init_clip_weights(model, gen)
        self.model = model.to(self.device).eval().requires_grad_(False)

    def tokenize(self, captions: Sequence[str]) -> np.ndarray:
        if self.tokenizer is None:
            return hash_tokenize(captions, self.max_length)
        return self.tokenizer(captions)

    @torch.no_grad()
    def encode(self, input_ids) -> torch.Tensor:
        """(B, 77) ids -> (B, 77, hidden) last hidden state, f32."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        return self.model(ids)

    def uncond_embedding(self, batch: int = 1) -> torch.Tensor:
        """The empty prompt's embedding, repeated ``batch`` times."""
        return self.encode(self.tokenize([""])).repeat(batch, 1, 1)
