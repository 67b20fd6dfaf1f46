"""Carry a JAX parameter tree across to the port.

Counterpart, in the inverse direction, of ``onedc_tpu/utils/port_torch.py``.
The port's modules carry the flax module names, so a flax path maps
mechanically onto a state-dict key:

    unet/down_blocks_0/resnets_0/conv1/kernel
        -> unet.down_blocks_0.resnets_0.conv1.weight

Leaves convert as: conv kernel HWIO -> OIHW (a depthwise (3, 3, 1, C)
kernel becomes (C, 1, 3, 3) by the same transpose); Dense kernel
(in, out) -> (out, in); GroupNorm / LayerNorm ``scale`` -> ``weight``;
``bias``, the Swin ``pos_embedding`` (ws², ws²) and the VQGAN's
``quantize/embedding`` (K, D) as they are; any other leaf raises.
``OneDC.load_state_dict(..., strict=True)`` then raises on any key left
over on either side: every leaf
of the tree, the encode side (``vae/encoder``, ``codec/enc``,
``codec/hyper_enc``) included, must have its parameter in the port.

``state_dict_from_safetensors`` reads the inference CLI's ``ckpt=``
flavour: such a tree saved with "/"-joined keys, as
``onedc_tpu/utils/checkpoint.py:save_safetensors`` writes it.
``flat_state_dict`` reads the metric networks' converted files
(``nn/{lpips,dists,inception}.py``), whose few leaves that are neither a
kernel nor a bias keep their name and layout.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

from .safetensors import load_safetensors, tensor_from_numpy, \
    unflatten_params


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _leaves(v, path + "/")
        else:
            yield path, v


# leaves whose name and layout carry over unchanged
_AS_IS = ("bias", "pos_embedding", "embedding")


def convert_leaf(path: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """One flax leaf -> (state-dict key, array in torch layout)."""
    *mods, leaf = path.split("/")
    if leaf == "kernel":
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"{path}: kernel of rank {value.ndim}")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf not in _AS_IS:
        raise ValueError(f"{path}: unknown leaf kind {leaf!r}")
    return ".".join(mods + [leaf]), np.ascontiguousarray(value)


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of arrays, with or without the top
    ``params`` key) -> f32 state dict."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(params):
        key, arr = convert_leaf(path, np.asarray(value, np.float32))
        out[key] = tensor_from_numpy(arr)
    return out


def state_dict_from_safetensors(path) -> Dict[str, torch.Tensor]:
    """A safetensors file of a JAX param tree ("/"-joined keys, with or
    without the top ``params/``) -> f32 state dict."""
    flat = load_safetensors(path)
    return state_dict_from_jax(unflatten_params(
        {k: v.float().numpy() for k, v in flat.items()}))


def flat_state_dict(flat: Mapping[str, object], as_is: Sequence[str] = ()
                    ) -> Dict[str, torch.Tensor]:
    """A flat {"/"-joined path: array or CPU tensor} dict -> f32 state
    dict: the keys in ``as_is`` keep their name and layout, every other
    leaf goes through ``convert_leaf``."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        if isinstance(value, torch.Tensor):
            value = value.float().numpy()
        arr = np.asarray(value, np.float32)
        if path in as_is:
            key = path
        else:
            key, arr = convert_leaf(path, arr)
        out[key] = tensor_from_numpy(np.ascontiguousarray(arr))
    return out
