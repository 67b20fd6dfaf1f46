"""K2, fused GroupNorm-affine + SiLU + 3x3 conv, and K3, the plain 3x3
conv: hand-written CUDA kernels (``csrc/conv3x3.cu``).

JAX counterparts: ``onedc_tpu/ops/pallas_conv.py:404`` (``affine_silu_conv3x3``
-> ``_gn_silu_conv_fused`` :369 -> ``_conv3x3_v2_single`` :292, body
``_kernel_v2`` :219) for K2, and ``:153 conv3x3_same`` (->
``_conv3x3_pallas_single`` :89, body ``_kernel`` :43) for K3. On the H100 the
tensor cores bound both (18*H*W*Cin*Cout FLOPs, ~380 FLOP per byte at
768x768x256->128 in bf16). Both are implicit GEMMs on ``wgmma`` that stage
each input patch once per 64-channel chunk, as bf16, and, for K2, apply the
affine and the SiLU there, so the normalised tensor never reaches device
memory; the weights come by TMA from a bf16 (9*Cin, Cout) view. bf16 K2
(the decode path) loads its patches by TMA; f32 K2 (the training forward)
and K3 (f32 only) load f32 and round it to bf16 as they stage it, and the
wrapper rounds the f32 weights to a bf16 copy per launch. Cin and Cout
multiples of 64 in both dtypes.

``affine_silu_conv3x3(x, mul, add, w, bias)`` keeps the JAX signature and
layouts: x (B, H, W, Cin) NHWC, mul/add (B, Cin) f32 (GroupNorm statistics
folded into one affine, ``nn/blocks.py:group_norm_affine``), w (3, 3, Cin,
Cout) HWIO, i.e. [tap][Cin][Cout], bias (Cout,); x, w and bias all bf16 or
all f32. It returns ``conv3x3(silu(x * mul + add)) + bias`` as (B, H, W,
Cout). When autograd records it runs through ``AffineSiluConv3x3``, whose
backward does what ``_gnsc_bwd`` (:394-398) does: it recomputes
``silu(x * mul + add)`` in plain torch, takes the conv's input gradient
from K3 and its weight gradient from torch (the JAX package computes dw in
XLA too, :174-178), and the affine and SiLU chain rule in plain torch.

K3 enters the port as ``conv3x3_dx(g, w)``, the input gradient of the
custom VJP of ``pallas_conv.py:152-182``: the conv of g with spatially
flipped, in/out-transposed weights. The wrapper transposes and rounds w in
one pass (``dx_weights``); the kernel reads the taps in flipped order.

For CUDA tensors each wrapper launches its kernel (or raises on what the
kernel does not take); for CPU tensors it computes the plain version
(``affine_silu_conv3x3_plain``, ``conv3x3_plain``, ``conv3x3_dx_plain``).
A CUDA tensor never reaches a plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load_library

# the channel multiple of Cin and Cout the kernels take (one input chunk)
CHANNEL_MULTIPLE = 64

# launches of the CUDA kernels in this process (plain-version calls
# excluded): K2 (``launches``) and K3 (``conv_launches``)
launches = 0
conv_launches = 0

_DTYPES = (torch.bfloat16, torch.float32)

_SIGNATURES = {
    "onedc_gn_silu_conv3x3": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "onedc_conv3x3": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
}


def _conv_nhwc(x, w, bias=None):
    """Zero-padded stride-1 3x3 conv of NHWC x with HWIO w, in torch."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), bias,
                   padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


def affine_silu_conv3x3_plain(x, mul, add, w, bias):
    """The same function in plain PyTorch (``_gn_silu_conv_ref``,
    ``pallas_conv.py:359``): affine + SiLU in f32, rounded to x's dtype,
    then a zero-padded 3x3 conv."""
    t = F.silu(x.float() * mul[:, None, None, :] + add[:, None, None, :])
    return _conv_nhwc(t.to(x.dtype), w, bias)


def conv3x3_plain(x, w):
    """K3's function in plain PyTorch: conv3x3(x), zero border, no bias."""
    return _conv_nhwc(x, w)


def flip_weights(w):
    """HWIO (3, 3, Cin, Cout) -> (3, 3, Cout, Cin), spatially flipped: the
    weights whose conv of the output gradient is the input gradient
    (``pallas_conv.py:167``)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def dx_weights(w):
    """K3's weights for the forward weights w (3, 3, Cin, Cout), f32: w
    transposed to (3, 3, Cout, Cin) and rounded to bf16 in one pass, NOT
    flipped; the kernel reads tap t from tap 8 - t, so it convolves with
    ``flip_weights(w)`` rounded to bf16."""
    return w.transpose(2, 3).to(torch.bfloat16,
                                memory_format=torch.contiguous_format)


def conv3x3_dx_plain(g, w):
    """The input gradient of ``conv3x3_plain(x, w)`` for output gradient g,
    as K3 computes it: conv3x3 of g with the flipped weights."""
    return conv3x3_plain(g, flip_weights(w))


def conv3x3_dw(x, g, w_shape):
    """The weight gradient (HWIO) of conv3x3(x, w) for output gradient g,
    by torch's weight-gradient convolution (cuDNN on the card), as the JAX
    package leaves dw to XLA (``pallas_conv.py:174-178``)."""
    cin, cout = w_shape[2], w_shape[3]
    dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (cout, cin, 3, 3),
                                     g.permute(0, 3, 1, 2), padding=1)
    return dw.permute(2, 3, 1, 0)


def _check_conv(x, w, dtypes=_DTYPES):
    if x.dtype not in dtypes or w.dtype != x.dtype:
        raise TypeError(f"x and w must be of one dtype of {dtypes} (got "
                        f"{x.dtype}, {w.dtype})")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[3]
    if w.shape[:3] != (3, 3, cin) or w.dim() != 4:
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got "
                         f"{tuple(w.shape)}")
    cout = w.shape[3]
    if cin % CHANNEL_MULTIPLE or cout % CHANNEL_MULTIPLE:
        raise ValueError(f"Cin {cin} and Cout {cout} must be multiples of "
                         f"{CHANNEL_MULTIPLE}")


def _check_layout(x, named):
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _check(x, mul, add, w, bias):
    _check_conv(x, w)
    if bias.dtype != x.dtype:
        raise TypeError(f"bias must be {x.dtype}, got {bias.dtype}")
    if mul.dtype != torch.float32 or add.dtype != torch.float32:
        raise TypeError("mul and add must be f32")
    b, cin = x.shape[0], x.shape[3]
    if mul.shape != (b, cin) or add.shape != (b, cin) or \
            bias.shape != (w.shape[3],):
        raise ValueError("mul/add must be (B, Cin) and bias (Cout,)")
    _check_layout(x, (("x", x), ("mul", mul), ("add", add), ("w", w),
                      ("bias", bias)))


def affine_silu_conv3x3_cuda(x, mul, add, w, bias):
    """Launch K2 on x's current stream (f32: on a bf16 copy of w)."""
    global launches
    _check(x, mul, add, w, bias)
    lib = load_library("conv3x3", _SIGNATURES)
    b, h, width, cin = x.shape
    cout = w.shape[3]
    f32 = x.dtype == torch.float32
    wk = w.to(torch.bfloat16) if f32 else w
    out = torch.empty((b, h, width, cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.onedc_gn_silu_conv3x3(
        x.data_ptr(), mul.data_ptr(), add.data_ptr(), wk.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, h, width, cin, cout, int(f32),
        stream)
    if err != 0:
        raise RuntimeError(f"gn_silu_conv3x3 launch failed: CUDA error {err}")
    launches += 1
    return out


def conv3x3_dx_cuda(g, w):
    """Launch K3 (f32) on g's current stream: the input gradient of
    conv3x3(x, w) for output gradient g (B, H, W, Cout), w (3, 3, Cin,
    Cout)."""
    global conv_launches
    _check_conv(g, w.transpose(2, 3), (torch.float32,))
    _check_layout(g, (("g", g), ("w", w)))
    lib = load_library("conv3x3", _SIGNATURES)
    b, h, width, cin = g.shape
    cout = w.shape[2]
    wk = dx_weights(w)
    out = torch.empty((b, h, width, cout), dtype=g.dtype, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.onedc_conv3x3(g.data_ptr(), wk.data_ptr(), out.data_ptr(), b, h,
                            width, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 launch failed: CUDA error {err}")
    conv_launches += 1
    return out


def conv3x3_dx(g, w):
    """The input gradient of conv3x3(x, w) for output gradient g (B, H, W,
    Cout): K3 on the card, the plain version on the CPU."""
    if g.is_cuda:
        return conv3x3_dx_cuda(g.contiguous(), w)
    return conv3x3_dx_plain(g, w)


def affine_silu_conv3x3_bwd(x, mul, add, w, g):
    """Gradients (dx, dmul, dadd, dw, dbias) of affine_silu_conv3x3 for
    output gradient g, as ``_gnsc_bwd`` (``pallas_conv.py:394-398``)
    computes them through the unfused composition: the SiLU input recomputed
    in f32, dt = conv3x3_dx(g, w) (K3 on the card), dw from torch, the chain
    rule of the affine and the SiLU in plain torch."""
    u = x.float() * mul[:, None, None, :] + add[:, None, None, :]
    sig = torch.sigmoid(u)
    t = (u * sig).to(x.dtype)
    dt = conv3x3_dx(g, w)
    du = dt.float() * (sig * (1 + u * (1 - sig)))
    dx = (du * mul[:, None, None, :]).to(x.dtype)
    dmul = (du * x.float()).sum((1, 2))
    dadd = du.sum((1, 2))
    dw = conv3x3_dw(t, g, list(w.shape)).to(w.dtype)
    dbias = g.sum((0, 1, 2)).to(w.dtype)
    return dx, dmul, dadd, dw, dbias


class AffineSiluConv3x3(torch.autograd.Function):
    """K2 with the backward of ``_gnsc_bwd`` (``affine_silu_conv3x3_bwd``)."""

    @staticmethod
    def forward(ctx, x, mul, add, w, bias):
        ctx.save_for_backward(x, mul, add, w)
        if x.is_cuda:
            return affine_silu_conv3x3_cuda(x, mul, add, w, bias)
        return affine_silu_conv3x3_plain(x, mul, add, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, mul, add, w = ctx.saved_tensors
        return affine_silu_conv3x3_bwd(x, mul, add, w, g.contiguous())


def affine_silu_conv3x3(x, mul, add, w, bias):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, mul, add, w, bias)):
        return AffineSiluConv3x3.apply(x, mul, add, w, bias)
    if x.is_cuda:
        return affine_silu_conv3x3_cuda(x, mul, add, w, bias)
    return affine_silu_conv3x3_plain(x, mul, add, w, bias)
