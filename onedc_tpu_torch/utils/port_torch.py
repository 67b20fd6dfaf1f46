"""The reference's released torch checkpoints -> the port's state dict.

JAX counterpart: ``onedc_tpu/utils/port_torch.py`` (``merge_lora`` :51,
the rule tables :109-284, ``port_state_dict`` :299, ``_assemble`` :432,
``port_onedc_checkpoint`` :469), in what the lambda and z-only models and
the stage-I Codeformer need:

- ``model.safetensors``   (SD1.5 UNet + peft LoRA + conv_in +
  vae_reduction)              -> ``unet.*``, LoRA merged
- ``model_1.safetensors`` (IntraNoAR codec)   -> ``codec.*``
- a diffusers SD2.1 VAE state dict            -> ``vae.*``
- a Codeformer state dict                     -> ``codeformer.*``
  (``port_codeformer_state``, JAX :236-280, :367-373)
- a MaskGIT-VQGAN torch state dict            -> ``vqgan.*``
  (``port_vqgan_state``, JAX :361-364; wired no further than the JAX
  package wires it: ``port_onedc_checkpoint`` takes no VQGAN path)

The rule tables are the JAX package's, unchanged: they rename a reference
module path onto the module path of the flax tree, whose module names the
port keeps (``utils/convert.py``), so a renamed path with its separators
made dots is a key of ``OneDC().state_dict()``. Tensors keep the torch
layout, which is the port's (OIHW convs, (out, in) linears, ``weight`` of
a norm): no transpose. Every tensor is read as f32 before the LoRA merge,
which is the JAX package's arithmetic (the delta in f32 by ``np.einsum``
or ``@``, added in f64).

The target's own state dict (``reference``: a module's ``state_dict()``,
on the ``meta`` device if only keys and shapes matter) is the reference
for keys and shapes: an unmatched name, a shape mismatch, or, under
``require_complete``, a key of a named submodule left unfilled raises.

LayerNorm eps stays the JAX package's 1e-6 (``nn/unet_sd.py``); diffusers'
SD1.5 uses 1e-5, a documented difference (``ROADMAP.md``).
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .safetensors import load_safetensors, tensor_from_numpy

StateSource = Union[str, "os.PathLike[str]", Mapping[str, object]]


def _f32(value) -> np.ndarray:
    """A checkpoint tensor (torch, any float dtype, or numpy) as f32 numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(torch.float32).cpu().numpy()
    return np.asarray(value, np.float32)


# ---------------------------------------------------------------------------
# LoRA merge (peft layout)
# ---------------------------------------------------------------------------

def _lora_delta(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.ndim == 2:
        return b @ a
    # conv: A (r, in, kh, kw), B (out, r, 1, 1)
    if b.shape[2:] != (1, 1):
        return np.einsum("orab,rikh->oikh", b, a)
    return np.einsum("or,rikh->oikh", b[:, :, 0, 0], a)


def _merge_one(w: np.ndarray, a: np.ndarray, b: np.ndarray,
               scale: float) -> np.ndarray:
    """w + scale * (B A), summed in f64 (as the JAX package), in w's dtype."""
    merged = _lora_delta(a, b).astype(np.float64)
    merged *= scale
    merged += w
    return merged.astype(w.dtype)


def merge_lora(state: Mapping[str, np.ndarray], rank: int = 64,
               alpha: float = 8.0) -> Dict[str, np.ndarray]:
    """Fold peft LoRA adapters into their base weights.

    ``X.base_layer.weight`` + ``X.lora_A.default.weight`` /
    ``X.lora_B.default.weight`` give ``X.weight`` = base + (alpha / rank)
    * B A, for linear and conv layers. The merges run on a thread pool
    (``np.einsum``, single-threaded for the conv adapters, and ``@``
    release the interpreter lock); each is the same arithmetic as alone.
    ``tools/time_lora_merge.py`` times the pool against one thread on the
    full-layout UNet.
    """
    out: Dict[str, np.ndarray] = {}
    lora_a: Dict[str, np.ndarray] = {}
    lora_b: Dict[str, np.ndarray] = {}
    for k, v in state.items():
        m = re.match(r"(.*)\.lora_A\.[^.]+\.weight$", k)
        if m:
            lora_a[m.group(1)] = v
            continue
        m = re.match(r"(.*)\.lora_B\.[^.]+\.weight$", k)
        if m:
            lora_b[m.group(1)] = v
            continue
        if ".lora_" in k:  # lora bias / embedding variants unused
            continue
        out[k.replace(".base_layer", "")] = v

    scale = alpha / rank
    jobs = []
    for base, a in lora_a.items():
        b = lora_b.get(base)
        if b is None:
            raise KeyError(f"lora_A without lora_B at {base}")
        key = f"{base}.weight"
        if key not in out:
            raise KeyError(f"lora target missing base weight: {key}")
        jobs.append((key, out[key], a, b))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        merged = ex.map(lambda job: _merge_one(*job[1:], scale), jobs)
        for (key, *_), value in zip(jobs, merged):
            out[key] = value
    return out


# ---------------------------------------------------------------------------
# rule-based renaming (the JAX package's tables)
# ---------------------------------------------------------------------------

Rule = Tuple[str, str]


def _apply_rules(name: str, rules: List[Rule]) -> str:
    for pat, rep in rules:
        name = re.sub(pat, rep, name)
    return name


# DepthConvBlock4 / DepthConv / ConvFFN3 internals (dcvc.py:242-266,353-368,
# 424-433) and ResidualBlockUpsample (dcvc.py:183-205)
_DCVC_RULES: List[Rule] = [
    (r"\.block\.0\.conv1\.0\.", r"/dc/conv1_0."),
    (r"\.block\.0\.depth_conv\.", r"/dc/depth_conv."),
    (r"\.block\.0\.conv2\.", r"/dc/conv2."),
    (r"\.block\.0\.adaptor\.", r"/dc/adaptor."),
    (r"\.block\.1\.conv\.", r"/ffn/conv."),
    (r"\.block\.1\.conv_out\.", r"/ffn/conv_out."),
    (r"\.subpel_conv\.0\.", r"/subpel_conv/conv."),
    (r"\.upsample\.0\.", r"/upsample/conv."),
]

# torch Sequential indices of IntraNoAR -> the port's module names
_CODEC_RULES: List[Rule] = [
    # encoder
    (r"^enc\.pix_emb\.", r"enc/pix_emb."),
    (r"^enc\.pix_fusion\.", r"enc/pix_fusion."),
    (r"^enc\.unet\.conv_in\.3\.", r"enc/unet/conv_in_down."),
    (r"^enc\.unet\.conv_in\.(\d)\.", r"enc/unet/conv_in_res\1."),
    (r"^enc\.unet\.time_embedding\.", r"enc/unet/time_embedding/"),
    (r"^enc\.unet\.(down_blocks|up_blocks)\.(\d)\.(resnets|attentions)\.(\d)\.",
     r"enc/unet/\1_\2/\3_\4/"),
    (r"^enc\.unet\.(down_blocks|up_blocks)\.(\d)\.(downsamplers|upsamplers)\.0\.conv\.",
     r"enc/unet/\1_\2/\3_0/conv."),
    (r"^enc\.unet\.mid_block\.(resnets|attentions)\.(\d)\.",
     r"enc/unet/mid_block/\1_\2/"),
    (r"^enc\.unet\.conv_norm_out\.", r"enc/unet/conv_norm_out."),
    (r"^enc\.unet\.conv_out\.", r"enc/unet/conv_out."),
    (r"^enc\.trans_coding\.0\.", r"enc/tc_bottleneck/res0."),
    (r"^enc\.trans_coding\.1\.", r"enc/tc_bottleneck/attn."),
    (r"^enc\.trans_coding\.2\.", r"enc/tc_bottleneck/res1."),
    (r"^enc\.trans_coding\.3", r"enc/tc_block0"),
    (r"^enc\.trans_coding\.4", r"enc/tc_block1"),
    # decoder
    (r"^dec\.trans_coding\.0", r"dec/tc_block0"),
    (r"^dec\.trans_coding\.1", r"dec/tc_block1"),
    (r"^dec\.blocks\.([012])\.", r"dec/res16_\1."),
    (r"^dec\.blocks\.3\.", r"dec/up/conv_expand."),
    (r"^dec\.blocks\.5\.", r"dec/up/conv_out."),
    (r"^dec\.blocks\.6\.", r"dec/res8_0."),
    (r"^dec\.blocks\.7\.", r"dec/res8_1."),
    (r"^dec\.blocks\.8\.", r"dec/res8_2."),
    (r"^dec\.sem_up\.0", r"dec/sem_up0"),
    (r"^dec\.sem_up\.1", r"dec/sem_block0"),
    (r"^dec\.sem_up\.2", r"dec/sem_up1"),
    (r"^dec\.sem_up\.3", r"dec/sem_block1"),
    (r"^dec\.sem_up\.4", r"dec/sem_up2"),
    (r"^dec\.conv_out", r"dec/conv_out"),
    # semantic adaptor
    (r"^semantic_adaptor\.to_semantic\.0", r"semantic_adaptor/block_in"),
    (r"^semantic_adaptor\.to_semantic\.1\.", r"semantic_adaptor/g0_res0."),
    (r"^semantic_adaptor\.to_semantic\.2\.", r"semantic_adaptor/g0_attn0."),
    (r"^semantic_adaptor\.to_semantic\.3\.", r"semantic_adaptor/g0_attn1."),
    (r"^semantic_adaptor\.to_semantic\.4\.", r"semantic_adaptor/g1_res0."),
    (r"^semantic_adaptor\.to_semantic\.5\.", r"semantic_adaptor/g1_attn0."),
    (r"^semantic_adaptor\.to_semantic\.6\.", r"semantic_adaptor/g1_attn1."),
    (r"^semantic_adaptor\.to_semantic\.7", r"semantic_adaptor/block_out"),
    # hyper encoder / decoder
    (r"^hyper_enc\.y_trans_coding\.0", r"hyper_enc/ytc_block0"),
    (r"^hyper_enc\.y_trans_coding\.1\.", r"hyper_enc/ytc_down0."),
    (r"^hyper_enc\.y_trans_coding\.2", r"hyper_enc/ytc_block1"),
    (r"^hyper_enc\.y_trans_coding\.3\.", r"hyper_enc/ytc_down1."),
    (r"^hyper_enc\.fusion\.0", r"hyper_enc/fusion_block0"),
    (r"^hyper_enc\.fusion\.1\.", r"hyper_enc/fusion_attn0."),
    (r"^hyper_enc\.fusion\.2", r"hyper_enc/fusion_block1"),
    (r"^hyper_enc\.fusion\.3\.", r"hyper_enc/fusion_attn1."),
    (r"^hyper_enc\.fusion\.4", r"hyper_enc/fusion_block2"),
    (r"^hyper_enc\.fusion\.5\.", r"hyper_enc/fusion_out."),
    (r"^hyper_dec\.feat_in\.0\.", r"hyper_dec/feat_in."),
    (r"^hyper_dec\.to_entropy\.0", r"hyper_dec/ent_block0"),
    (r"^hyper_dec\.to_entropy\.1\.", r"hyper_dec/ent_up0."),
    (r"^hyper_dec\.to_entropy\.2", r"hyper_dec/ent_block1"),
    (r"^hyper_dec\.to_entropy\.3\.", r"hyper_dec/ent_up1."),
    (r"^hyper_dec\.to_entropy\.4", r"hyper_dec/ent_block2"),
    # priors
    (r"^y_prior_fusion\.0", r"y_prior_fusion/block0"),
    (r"^y_prior_fusion\.1", r"y_prior_fusion/block1"),
    (r"^y_spatial_prior\.0", r"y_spatial_prior/block0"),
    (r"^y_spatial_prior\.1", r"y_spatial_prior/block1"),
    (r"^y_spatial_prior\.2", r"y_spatial_prior/block2"),
    (r"^y_spatial_prior_adaptor_(\d)\.", r"y_spatial_prior_adaptor_\1."),
    (r"^y_spatial_prior_reduction\.", r"y_spatial_prior_reduction."),
] + _DCVC_RULES

_SD_UNET_RULES: List[Rule] = [
    (r"^vae_reduction\.blocks\.0\.", r"vae_reduction/norm1."),
    (r"^vae_reduction\.blocks\.2\.", r"vae_reduction/conv1."),
    (r"^vae_reduction\.blocks\.3\.", r"vae_reduction/norm2."),
    (r"^vae_reduction\.blocks\.5\.", r"vae_reduction/conv2."),
    (r"^vae_reduction\.short_cut\.", r"vae_reduction/short_cut."),
    (r"^time_embedding\.", r"time_embedding/"),
    (r"^(down_blocks|up_blocks)\.(\d)\.(resnets|attentions)\.(\d)\.",
     r"\1_\2/\3_\4/"),
    (r"^(down_blocks|up_blocks)\.(\d)\.(downsamplers|upsamplers)\.0\.conv\.",
     r"\1_\2/\3_0/conv."),
    (r"^mid_block\.(resnets|attentions)\.(\d)\.", r"mid_block/\1_\2/"),
    # inner transformer rules accept both separators: the enclosing
    # block rule above has already rewritten its suffix "." to "/"
    (r"[./]transformer_blocks\.(\d)\.", r"/transformer_blocks_\1/"),
    (r"[./]ff\.net\.0\.proj\.", r"/ff/net_0/proj."),
    (r"[./]ff\.net\.2\.", r"/ff/net_2."),
    (r"[./]to_out\.0\.", r"/to_out_0."),
    (r"[./]attn(\d)\.", r"/attn\1/"),
    (r"[./]norm(\d)\.", r"/norm\1."),
]

_VAE_RULES: List[Rule] = [
    (r"^quant_conv\.", r"encoder/quant_conv."),
    (r"^post_quant_conv\.", r"decoder/post_quant_conv."),
    (r"^(encoder|decoder)\.conv_in\.", r"\1/conv_in."),
    (r"^(encoder|decoder)\.conv_norm_out\.", r"\1/conv_norm_out."),
    (r"^(encoder|decoder)\.conv_out\.", r"\1/conv_out."),
    (r"^(encoder|decoder)\.mid_block\.(resnets|attentions)\.(\d)\.",
     r"\1/mid_block/\2_\3/"),
    (r"^(encoder|decoder)\.(down_blocks|up_blocks)\.(\d)\.resnets\.(\d)\.",
     r"\1/\2_\3/resnets_\4/"),
    (r"^(encoder|decoder)\.(down_blocks|up_blocks)\.(\d)\.downsamplers\.0\.conv\.",
     r"\1/\2_\3/downsamplers_0."),
    (r"^(encoder|decoder)\.(down_blocks|up_blocks)\.(\d)\.upsamplers\.0\.conv\.",
     r"\1/\2_\3/upsamplers_0."),
]

# Swin blocks (ref blocks/swin.py:134-196): attention_block -> attn,
# FeedForward net indices -> mlp_0/mlp_2; the shifted blocks' additive
# masks are static on the port's side (skipped at the call sites).
_SWIN_RULES: List[Rule] = [
    (r"\.attention_block\.", r"/attn/"),
    (r"\.mlp_block\.net\.0\.", r"/mlp_0."),
    (r"\.mlp_block\.net\.2\.", r"/mlp_2."),
]

# Codeformer (ref codec_module.py:472-503): up_sample Sequential ->
# up_block0/up_expand/up_block1, blocks.N -> swinN, mlp_head Sequential
# -> head_0/head_norm0/head_3/head_norm1/head_out.
_CODEFORMER_RULES: List[Rule] = [
    (r"^up_sample\.0", r"up_block0"),
    (r"^up_sample\.1\.", r"up_expand."),
    (r"^up_sample\.3", r"up_block1"),
    (r"^blocks\.(\d)\.", r"swin\1/"),
    (r"^mlp_head\.0\.", r"head_0."),
    (r"^mlp_head\.1\.", r"head_norm0."),
    (r"^mlp_head\.3\.", r"head_3."),
    (r"^mlp_head\.4\.", r"head_norm1."),
    (r"^mlp_head\.6\.", r"head_out."),
] + _SWIN_RULES + _DCVC_RULES

_SWIN_SKIP = (r"upper_lower_mask", r"left_right_mask", r"relative_indices")

_VQGAN_RULES: List[Rule] = [
    (r"^quantize\.embedding\.weight$", r"quantize/embedding"),
    (r"^(encoder|decoder)\.conv_in\.", r"\1/conv_in."),
    (r"^(encoder|decoder)\.norm_out\.", r"\1/norm_out."),
    (r"^(encoder|decoder)\.conv_out\.", r"\1/conv_out."),
    (r"^encoder\.down\.(\d)\.block\.(\d)\.", r"encoder/down_\1_block_\2."),
    (r"^encoder\.mid\.(\d)\.", r"encoder/mid_\1."),
    (r"^decoder\.mid\.(\d)\.", r"decoder/mid_\1."),
    (r"^decoder\.up\.(\d)\.block\.(\d)\.", r"decoder/up_\1_block_\2."),
    (r"^decoder\.up\.(\d)\.upsample_conv\.", r"decoder/up_\1_conv."),
]

# generic: diffusers Attention's to_out is a ModuleList(Linear, Dropout).
# Separator class [./]: an enclosing rule may already have rewritten the
# preceding "." to "/".
_GENERIC_RULES: List[Rule] = [
    (r"[./]to_out\.0\.", r".to_out."),
]


def port_state_dict(state: Mapping[str, object], rules: List[Rule],
                    skip: Tuple[str, ...] = (),
                    raw_keys: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    """Rename every tensor of a reference state dict onto a port key
    (relative to the submodule the rules address) and read it as f32, in
    the torch layout. ``raw_keys``: patterns of names whose renamed path
    is the key itself, with no ``weight`` / ``bias`` leaf split off (an
    ``nn.Embedding`` weight, a raw parameter such as ``pos_embedding``),
    as the JAX porter's ``raw_keys``. Raises KeyError for a name the rules
    leave with a bare index (an unmapped Sequential entry) or whose leaf is
    neither ``weight`` nor ``bias`` nor raw."""
    flat: Dict[str, np.ndarray] = {}
    for key, arr in state.items():
        if any(re.search(s, key) for s in skip):
            continue
        if any(re.search(p, key) for p in raw_keys):
            stem, leaf = (key[:-len(".weight")] if key.endswith(".weight")
                          else key), None
        else:
            stem, _, leaf = key.rpartition(".")
            if leaf not in ("weight", "bias"):
                raise KeyError(f"unmapped torch name: {key} (leaf "
                               f"{leaf!r})")
        renamed = _apply_rules(stem + ".", rules + _GENERIC_RULES)
        path = renamed.rstrip("./").replace("/", ".")
        if re.search(r"(^|\.)\d+(\.|$)", path):
            raise KeyError(f"unmapped torch name: {key} -> {path}")
        flat[path if leaf is None else f"{path}.{leaf}"] = _f32(arr)
    return flat


def port_codec_state(state: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """IntraNoAR state dict -> ``codec.*`` keys (skips the coder buffers
    and the pytorch_msssim window a torch version may persist)."""
    return port_state_dict(state, _CODEC_RULES,
                           skip=(r"^masks\.", r"bit_estimator", r"gaussian",
                                 r"^ssim\.", r"^z_vq\."))


def port_sd_unet_state(state: Mapping[str, object], lora_rank: int = 64,
                       lora_alpha: float = 8.0) -> Dict[str, np.ndarray]:
    """model.safetensors (UNet + LoRA) -> ``unet.*`` keys, LoRA merged."""
    state = merge_lora({k: _f32(v) for k, v in state.items()}, lora_rank,
                       lora_alpha)
    return port_state_dict(state, _SD_UNET_RULES)


def port_vae_state(state: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A diffusers AutoencoderKL state dict -> ``vae.*`` keys."""
    return port_state_dict(state, _VAE_RULES)


def port_vqgan_state(state: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A MaskGIT-VQGAN torch state dict -> ``vqgan.*`` keys; the
    ``quantize.embedding`` (K, D) stays as it is."""
    return port_state_dict(state, _VQGAN_RULES,
                           raw_keys=(r"^quantize\.embedding\.weight$",))


def port_codeformer_state(state: Mapping[str, object]
                          ) -> Dict[str, np.ndarray]:
    """A Codeformer state dict (the reference's ``codec_module.py:472-503``
    naming) -> ``codeformer.*`` keys: the Swin ``pos_embedding`` stays (ws²,
    ws²); the shifted windows' additive masks, static here, are skipped."""
    return port_state_dict(state, _CODEFORMER_RULES, skip=_SWIN_SKIP,
                           raw_keys=(r"\.pos_embedding$",))


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def _load_state(src: StateSource) -> Mapping[str, object]:
    if isinstance(src, Mapping):
        return src
    return load_safetensors(src)


def _assemble(reference: Mapping[str, torch.Tensor],
              fills: Dict[str, Dict[str, np.ndarray]],
              require_complete: Tuple[str, ...] = ()
              ) -> Dict[str, torch.Tensor]:
    """The reference state dict with each ported tensor in place of its
    key's entry, in the reference entry's dtype."""
    out = dict(reference)
    filled = set()
    for sub, flat in fills.items():
        for k, v in flat.items():
            full = f"{sub}.{k}"
            ref = reference.get(full)
            if ref is None:
                raise KeyError(f"ported tensor has no home: {full}")
            if tuple(ref.shape) != v.shape:
                raise ValueError(f"shape mismatch at {full}: ckpt {v.shape} "
                                 f"vs model {tuple(ref.shape)}")
            out[full] = tensor_from_numpy(v).to(ref.dtype)
            filled.add(full)
    for sub in require_complete:
        missing = sorted(k for k in reference
                         if k.startswith(f"{sub}.") and k not in filled)
        if missing:
            raise KeyError(f"checkpoint does not cover {len(missing)} model "
                           f"tensors under {sub}: {missing[:8]} ...")
    return out


def port_onedc_checkpoint(unet_path: Optional[StateSource] = None,
                          codec_path: Optional[StateSource] = None,
                          vae_path: Optional[StateSource] = None,
                          codeformer_path: Optional[StateSource] = None,
                          reference: Optional[Mapping[str, torch.Tensor]]
                          = None,
                          require_complete: Tuple[str, ...] = ()
                          ) -> Dict[str, torch.Tensor]:
    """A OneDC state dict from the reference's checkpoint files.

    ``reference``: the target model's ``state_dict()`` (keys, shapes,
    dtypes; entries no checkpoint fills are returned as they are). Each
    ``*_path`` is a safetensors file or an in-memory ``{name: tensor or
    array}`` in the reference's naming and layout. ``require_complete``:
    submodule names ("unet", "codec", "vae", "codeformer") every key of
    which a checkpoint must fill.
    """
    if reference is None:
        raise ValueError("port_onedc_checkpoint needs the reference state "
                         "dict of the target model")
    fills: Dict[str, Dict[str, np.ndarray]] = {}
    if unet_path is not None:
        fills["unet"] = port_sd_unet_state(_load_state(unet_path))
    if codec_path is not None:
        fills["codec"] = port_codec_state(_load_state(codec_path))
    if vae_path is not None:
        fills["vae"] = port_vae_state(_load_state(vae_path))
    if codeformer_path is not None:
        fills["codeformer"] = port_codeformer_state(
            _load_state(codeformer_path))
    return _assemble(reference, fills, require_complete)
