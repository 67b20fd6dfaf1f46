"""The w8a8 serving mode: which ops of a decode run in int8, and when.

JAX counterpart: ``onedc_tpu/nn/quant.py`` (``QUANT_PREFIXES`` :64,
``_Q8_UPSAMPLE`` :69, ``_Q8_MIN_CH`` :87, ``_w8a8_interceptor`` :202,
``w8a8_methods`` :231). The arithmetic is ``ops/w8a8.py``.

Inside ``w8a8_scope(table)`` a module of the table runs as its quantized op
(the ``Conv2d``, ``Linear`` and ``UpsampleConv2x`` of ``nn/blocks.py``: the
counterparts of the exact-type ``nn.Conv``, ``nn.Dense`` and
``UpsampleConv2x`` that the JAX interceptor takes) when its input has at
least two dims and its input and output channels both reach the gate
``ONEDC_Q8_MIN_CH`` (default 512), the upsample convs unless
``ONEDC_Q8_UPSAMPLE=0``; both are read when a scope is entered, as the JAX
package reads them when it traces. ``w8a8_table(model)`` holds the modules
under ``QUANT_PREFIXES``: the UNet, the VAE decoder and the TinyVAE.
Everything else runs exact: attention (K1), the codec nets, encode, and
the VAE resnets' convs, which hold K2's weights and never run as modules
(the JAX package's ``Conv2dParams``). A runtime owns its table
(``OneDCRuntime.quantized``), so one model serves an exact and a w8a8
runtime side by side.
"""

from __future__ import annotations

import contextlib
import functools
import os
from contextvars import ContextVar
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.w8a8 import w8a8_conv, w8a8_dense, w8a8_upsample

# state dict prefixes of the modules that quantize: the decode-only
# quality stages (JAX ``QUANT_PREFIXES``)
QUANT_PREFIXES = ("unet.", "vae.decoder.", "vae_tiny_dec.")

DEFAULT_MIN_CH = 512


class QuantOp(NamedTuple):
    """One op that ran quantized: its module's state dict path, rule
    ("conv", "dense", "upsample"), family (``family``), channels and input
    shape."""

    path: str
    rule: str
    family: str
    cin: int
    cout: int
    shape: Tuple[int, ...]


class _Scope(NamedTuple):
    table: Dict[nn.Module, Tuple[str, str]]
    min_ch: int
    upsample: bool


_SCOPE: ContextVar[Optional[_Scope]] = ContextVar("onedc_w8a8_scope",
                                                  default=None)
_RECORD: ContextVar[Optional[List[QuantOp]]] = ContextVar(
    "onedc_w8a8_record", default=None)


def _square(v) -> int:
    """A conv's stride or padding as one int (w8a8 takes square ones)."""
    v = (v, v) if isinstance(v, int) else tuple(v)
    if len(set(v)) != 1 or not isinstance(v[0], int):
        raise ValueError(f"w8a8 convs take square int strides and pads, "
                         f"got {v}")
    return v[0]


def family(rule: str, module: nn.Module, x: torch.Tensor) -> str:
    """The family of a quantized call: conv1x1, conv3x3, conv3x3_s2 (and
    conv{kh}x{kw}_s{s} otherwise), upsample, dense, or time_dense (a dense
    on (B, C) rows: the UNet's time-embedding denses)."""
    if rule == "dense":
        return "time_dense" if x.dim() == 2 else "dense"
    if rule == "upsample":
        return rule
    kh, kw = module.kernel_size
    s = _square(module.stride)
    return f"conv{kh}x{kw}" + ("" if s == 1 else f"_s{s}")


def _run(rule: str, module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if rule == "dense":
        return w8a8_dense(x, module.weight, module.bias)
    if rule == "upsample":
        return w8a8_upsample(x, module.weight, module.bias)
    if module.groups != 1 or _square(module.dilation) != 1:
        raise ValueError("w8a8 convs take groups=1 and no dilation")
    return w8a8_conv(x, module.weight, module.bias, _square(module.stride),
                     _square(module.padding))


def intercept(module: nn.Module, x: torch.Tensor) -> Optional[torch.Tensor]:
    """The w8a8 output of ``module`` on ``x`` where the active scope takes
    the call, else None (the module then runs exact)."""
    scope = _SCOPE.get()
    if scope is None:
        return None
    entry = scope.table.get(module)
    if entry is None or x.dim() < 2:
        return None
    path, rule = entry
    if rule == "dense":
        cin, cout = x.shape[-1], module.out_features
    else:
        cin, cout = x.shape[1], module.out_channels
    if min(cin, cout) < scope.min_ch or (rule == "upsample"
                                         and not scope.upsample):
        return None
    record = _RECORD.get()
    if record is not None:
        record.append(QuantOp(path, rule, family(rule, module, x), cin, cout,
                              tuple(x.shape)))
    return _run(rule, module, x)


def w8a8_table(model: nn.Module) -> Dict[nn.Module, Tuple[str, str]]:
    """{module: (state dict path, rule)} of the modules of ``model`` that
    the w8a8 mode may take: those under ``QUANT_PREFIXES`` whose class has
    a ``w8a8_rule``."""
    return {m: (name, m.w8a8_rule) for name, m in model.named_modules()
            if name.startswith(QUANT_PREFIXES)
            and getattr(m, "w8a8_rule", None)}


def min_channels() -> int:
    """The gate: ``ONEDC_Q8_MIN_CH``, default 512."""
    return int(os.environ.get("ONEDC_Q8_MIN_CH", str(DEFAULT_MIN_CH)))


@contextlib.contextmanager
def w8a8_scope(table: Dict[nn.Module, Tuple[str, str]]):
    """Run the modules of ``table`` in w8a8 (the JAX ``w8a8_methods``),
    with the gate and the upsample switch read now."""
    token = _SCOPE.set(_Scope(
        table, min_channels(),
        os.environ.get("ONEDC_Q8_UPSAMPLE", "1") != "0"))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def scoped(table: Dict[nn.Module, Tuple[str, str]], fn):
    """``fn`` that runs inside ``w8a8_scope(table)``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with w8a8_scope(table):
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def recording():
    """Collect a ``QuantOp`` of every op that runs quantized inside."""
    ops: List[QuantOp] = []
    token = _RECORD.set(ops)
    try:
        yield ops
    finally:
        _RECORD.reset(token)
