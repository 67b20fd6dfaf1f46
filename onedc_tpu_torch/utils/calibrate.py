"""Bitstream-rate calibration for random-weight models.

JAX counterpart: ``onedc_tpu/utils/calibrate.py`` (``_HEAD_NAMES``,
``_TARGET_PREFIXES``, ``_is_head`` :42-85, ``calibrate_stream_params``
:88, ``pick_stream_scale`` :107). A freshly initialised OneDC codes y
residuals of O(1) against O(1) predicted means, so its streams run at
bits per pixel far above the released lambda family's 0.02-0.15 band,
and a serving time measured on them overstates the host rANS work and
never takes the int8 symbol upload. ``calibrate_stream_params`` scales
the output heads of every module that feeds the y quantiser (the
encoder's trans-coding blocks, the prior fusion, the spatial priors and
their reduction): each stack ends in residual blocks whose branches end
in a scaled conv and whose identity paths carry an already scaled tensor,
so y, the means and the scales become O(scale) and the quantised
residuals concentrate on {0, +-1}, the shape of a trained codec's stream.
The model stays a working codec; only the rate statistics move.

A benchmark calibration, not a training substitute: pick the scale with
``pick_stream_scale`` and report it and the bpp beside any time. The
port's state dict keys carry the flax module names (``utils/convert.py``),
so the JAX rules apply to the key's dotted path as they are.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# Residual-branch terminal convs: scaling these (weight and bias) scales a
# block's additive contribution; GroupNorm inside a branch renormalises its
# input, so the internal convs need no scaling.
#   DepthConv: conv2 (+ adaptor identity when in != out)
#   ConvFFN3:  conv_out
#   ResnetBlockVQ: conv2 (+ nin_shortcut)
#   AttnBlockVQ:   proj_out
_HEAD_NAMES = ("conv2", "adaptor", "conv_out", "nin_shortcut", "proj_out")

# codec-relative prefixes of the y-path output stacks; the encoder UNet's
# plain conv_out anchors the chain
_TARGET_PREFIXES = (
    ("enc", "unet", "conv_out"),
    ("enc", "tc_bottleneck"),
    ("enc", "tc_block0"),
    ("enc", "tc_block1"),
    ("y_prior_fusion",),
    ("y_spatial_prior",),
    ("y_spatial_prior_adaptor_1",),
    ("y_spatial_prior_adaptor_2",),
    ("y_spatial_prior_adaptor_3",),
    ("y_spatial_prior_reduction",),
)


def _is_head(path: Tuple[str, ...]) -> bool:
    """True for the weight / bias leaves to scale (``path``: a state dict
    key split at its dots)."""
    if "codec" not in path:
        return False
    rel = path[path.index("codec") + 1:]
    for pref in _TARGET_PREFIXES:
        if rel[:len(pref)] == pref:
            # plain convs listed as full prefixes scale directly
            if pref[-1] in ("conv_out", "y_spatial_prior_reduction"):
                return True
            return any(n in rel for n in _HEAD_NAMES)
    return False


def calibrate_stream_params(state: Dict[str, torch.Tensor], scale: float
                            ) -> Dict[str, torch.Tensor]:
    """A new state dict: ``state``'s tensors, the y-path output heads
    scaled by ``scale`` in (0, 1] (smaller: fewer bits) into new tensors of
    their dtype and device, the others shared. scale = 1.0 gives equal
    values."""
    return {k: ((v * scale).to(v.dtype) if _is_head(tuple(k.split(".")))
                else v)
            for k, v in state.items()}


def pick_stream_scale(encode_bpp_fn, band=(0.02, 0.15),
                      candidates=(0.5, 0.35, 0.25, 0.18, 0.12, 0.08,
                                  0.05, 0.03)):
    """Sweep calibration scales until the measured bpp lands in ``band``.

    ``encode_bpp_fn(scale) -> bpp_y`` encodes one probe image with the
    calibrated weights and returns its y-stream bpp. Returns (scale, bpp):
    the first candidate in the band, else the one of lowest bpp."""
    best = None
    for s in candidates:
        bpp = float(encode_bpp_fn(s))
        if best is None or bpp < best[1]:
            best = (s, bpp)
        if band[0] <= bpp <= band[1]:
            return s, bpp
    return best
