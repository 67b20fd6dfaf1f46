"""K2: fused GroupNorm-affine + SiLU + 3x3 conv, a hand-written CUDA kernel.

JAX counterpart: ``onedc_tpu/ops/pallas_conv.py:404`` (``affine_silu_conv3x3``
-> ``_gn_silu_conv_fused`` :369 -> ``_conv3x3_v2_single`` :292, body
``_kernel_v2`` :219). Kernel source: ``onedc_tpu_torch/csrc/gn_silu_conv3x3.cu``.
On the H100 the tensor cores bound it (18*H*W*Cin*Cout FLOPs, ~380 FLOP
per byte at 768x768x256->128); the kernel is an implicit GEMM on
``mma.sync`` bf16 that stages each input patch once per channel chunk and
applies the affine, the SiLU and the zero border there, so the normalised
tensor never reaches device memory.

``affine_silu_conv3x3(x, mul, add, w, bias)`` keeps the JAX signature and
layouts: x (B, H, W, Cin) NHWC, mul/add (B, Cin) f32 (GroupNorm statistics
folded into one affine, ``nn/blocks.py:group_norm_affine``), w (3, 3, Cin,
Cout) HWIO, i.e. [tap][Cin][Cout], bias (Cout,). It returns
``conv3x3(silu(x * mul + add)) + bias`` as (B, H, W, Cout). For CUDA tensors
it launches the kernel (or raises on what the kernel does not take); for CPU
tensors it computes ``affine_silu_conv3x3_plain``. A CUDA tensor never
reaches the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load_library

CIN_MULTIPLE = 32
COUT_MULTIPLE = 8

# launches of the CUDA kernel in this process (plain-version calls excluded)
launches = 0

_SIGNATURES = {
    "onedc_gn_silu_conv3x3": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}


def affine_silu_conv3x3_plain(x, mul, add, w, bias):
    """The same function in plain PyTorch (``_gn_silu_conv_ref``,
    ``pallas_conv.py:359``): affine + SiLU in f32, rounded to x's dtype,
    then a zero-padded 3x3 conv."""
    t = F.silu(x.float() * mul[:, None, None, :] + add[:, None, None, :])
    t = t.to(x.dtype).permute(0, 3, 1, 2)
    out = F.conv2d(t, w.permute(3, 2, 0, 1), bias, padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


def _check(x, mul, add, w, bias):
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 \
            or bias.dtype != torch.bfloat16:
        raise TypeError(f"x, w, bias must be bf16 (got {x.dtype}, {w.dtype}, "
                        f"{bias.dtype})")
    if mul.dtype != torch.float32 or add.dtype != torch.float32:
        raise TypeError("mul and add must be f32")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, _, _, cin = x.shape
    if w.shape[:3] != (3, 3, cin) or w.dim() != 4:
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got "
                         f"{tuple(w.shape)}")
    cout = w.shape[3]
    if cin % CIN_MULTIPLE or cout % COUT_MULTIPLE:
        raise ValueError(f"Cin {cin} must be a multiple of {CIN_MULTIPLE} "
                         f"and Cout {cout} of {COUT_MULTIPLE}")
    if mul.shape != (b, cin) or add.shape != (b, cin) or \
            bias.shape != (cout,):
        raise ValueError("mul/add must be (B, Cin) and bias (Cout,)")
    for name, t in (("x", x), ("mul", mul), ("add", add), ("w", w),
                    ("bias", bias)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def affine_silu_conv3x3_cuda(x, mul, add, w, bias):
    """Launch K2 on x's current stream."""
    global launches
    _check(x, mul, add, w, bias)
    lib = load_library("gn_silu_conv3x3", _SIGNATURES)
    b, h, width, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((b, h, width, cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.onedc_gn_silu_conv3x3(
        x.data_ptr(), mul.data_ptr(), add.data_ptr(), w.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, h, width, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"gn_silu_conv3x3 launch failed: CUDA error {err}")
    launches += 1
    return out


def affine_silu_conv3x3(x, mul, add, w, bias):
    if x.is_cuda:
        return affine_silu_conv3x3_cuda(x, mul, add, w, bias)
    return affine_silu_conv3x3_plain(x, mul, add, w, bias)
