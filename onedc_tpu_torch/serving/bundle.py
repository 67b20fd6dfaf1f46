"""A serving bundle as a serving process reads it: ``meta.json``, the
exported programs (``<name>.pt2``, ``utils/aot.py``) and the weights, with
no model code.

The weights come as a state dict or a flat safetensors file with the
state dict's keys. Each tensor is cast to the dtype the bundle was
exported in (JAX ``serving/decoder.py:92 _cast_params``) and laid out in
memory as the runtime laid it out at export (``meta.json``'s "weights":
channels_last convs on the card, the VAE convs' HWIO), so that the
programs run the runtime's kernels on the runtime's strides.
"""

from __future__ import annotations

import io
import json
import os
from typing import Callable, Dict

import torch

# registers the kernels' and the w8a8 ops' operators, which the programs
# call
from ..ops import conv3x3, flash_attention, w8a8  # noqa: F401
from ..utils.device import resolve_device
from ..utils.safetensors import load_safetensors


def load_exported(data: bytes, device=None, exported_on=None) -> Callable:
    """An artifact's bytes (``utils/aot.py``) -> a callable ``f(weights,
    *args)``, in a process that imports none of the model code.
    ``exported_on``: the device the program was traced on; a program bound
    for another device has its constants and device arguments moved
    there."""
    ep = torch.export.load(io.BytesIO(data))
    device = resolve_device(device)
    if exported_on is not None and torch.device(exported_on) != device:
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, device)
    return ep.module()


def _placed(src: torch.Tensor, info: dict, device) -> torch.Tensor:
    dtype = getattr(torch, info["dtype"])
    if "dim_order" in info:
        dst = torch.empty_permuted(info["shape"], info["dim_order"],
                                   dtype=dtype, device=device)
    else:
        dst = torch.empty(info["shape"], dtype=dtype, device=device)
    return dst.copy_(src)


class Bundle:
    """``bundle_dir``'s meta, its weights on ``device`` (the card unless
    named) and its programs, loaded once each by name."""

    def __init__(self, bundle_dir, weights, device=None):
        self.dir = bundle_dir
        with open(os.path.join(bundle_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.device = resolve_device(device)
        self.batch = int(self.meta["batch"])
        self.ds = int(self.meta["ds"])
        self.pad_h = int(self.meta["height"])
        self.pad_w = int(self.meta["width"])
        self.dtype = getattr(torch, self.meta["dtype"])
        if isinstance(weights, (str, os.PathLike)):
            weights = load_safetensors(weights)
        missing = [k for k in self.meta["weights"] if k not in weights]
        if missing:
            raise KeyError(f"weights lack {len(missing)} tensors of the "
                           f"bundle, e.g. {missing[:3]}")
        self.weights = {k: _placed(weights[k], info, self.device)
                        for k, info in self.meta["weights"].items()}
        # the loaded programs (graph modules) and the bound callables
        self.modules: Dict[str, torch.nn.Module] = {}
        self._programs: Dict[str, Callable] = {}

    def has(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.dir, f"{name}.pt2"))

    def program(self, name: str) -> Callable:
        """The program ``name`` as ``f(*args)``, its weights bound."""
        if name not in self._programs:
            path = os.path.join(self.dir, f"{name}.pt2")
            if not os.path.exists(path):
                raise FileNotFoundError(f"{path} missing: re-export the "
                                        f"bundle with utils/aot.py")
            with open(path, "rb") as f:
                fn = load_exported(f.read(), self.device,
                                   exported_on=self.meta["device"])
            prefixes = tuple(self.meta["programs"][name])
            weights = [w for k, w in self.weights.items()
                       if k.startswith(prefixes)]
            self.modules[name] = fn
            self._programs[name] = lambda *a: fn(weights, *a)
        return self._programs[name]
