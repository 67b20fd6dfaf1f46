"""The arithmetic of the w8a8 serving mode: symmetric int8 quantization,
int8 x int8 -> exact int32 products, and the quantized conv, dense and
upsample conv built from them.

JAX counterpart: ``onedc_tpu/nn/quant.py``, op for op. XLA computes it
there, not Pallas, so the port composes stock torch ops with one int8
product per op:

- ``quantize`` (``_quantize`` :94): symmetric int8 in f32, ``scale =
  max(amax, 1e-12) * f32(1/127)``, ``q = clip(round(x / scale), -127,
  127)`` with round-half-to-even and a true division. The source divides
  the scale by 127; XLA's algebraic simplifier turns that division by a
  constant into the product with its f32 reciprocal (the compiled CPU
  program's HLO shows it; the two differ by one ulp on some values), and
  the port computes what the JAX programs compute;
- weights per output channel, quantized inside every call from the working
  weights; activations per image for a conv and per token for a dense;
- int32 accumulation, dequantized as ``acc.f32 * (s_x * s_w)``, then
  ``+ bias.f32``, then cast to the promoted dtype of the input and the
  parameters (:139-143, :175-179);
- the upsample conv (``_upsample_w8a8`` :181): the 4x4 kernel ``k4`` of the
  lhs-dilated form built in f32 (four padded copies of the 3x3 kernel,
  added in the JAX order), quantized per output channel over all 16 taps,
  then computed at input resolution as four 2x2 phase convs that share
  that one scale: output pixel (2i+py, 2j+px) takes taps {py, py+2} x
  {px, px+2} of ``k4`` on the input padded by one
  (``onedc_tpu/nn/blocks.py:42-48``).

``int8_matmul(a, w) = a @ w.T`` (a (M, K), w (N, K), int32 out) is every
op's product: a conv's taps are gathered first (im2col of the NHWC int8
activations). On the card it is ``torch._int_mm`` (cuBLASLt on the int8
tensor cores) with a row-major and w column-major, the layout its int8
kernels take; that call needs M > 16 and K, N multiples of 8, so the
wrapper pads with zero rows and columns, which add nothing to any sum (a
time-embedding dense has B rows), and drops them. On a CPU tensor the plain
version computes the same integers as a float64 product: every partial sum
is an integer below 127^2 * K < 2^53. There is no other route: an int8
product the card cannot run raises.

Each quantized op is an operator (``torch.ops.onedc.w8a8_conv``,
``w8a8_dense``, ``w8a8_upsample``) whose body is that composition, so an
exported program (``utils/aot.py``) holds one node per op and runs the
composition on its device when it runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

# calls of torch._int_mm on the card in this process (plain-version calls
# excluded)
launches = 0

# f32(1/127), the factor of the scale (see the module docstring)
INV_127 = torch.tensor(1.0).div(127.0).item()

# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
MIN_ROWS = 17
MULTIPLE = 8


def _check(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype}, "
                        f"{w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"int8_matmul takes a (M, K) and w (N, K), got "
                         f"{tuple(a.shape)}, {tuple(w.shape)}")
    if a.device != w.device:
        raise ValueError(f"a is on {a.device}, w on {w.device}")


def int8_matmul_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T as int32, through an exact float64 product."""
    _check(a, w)
    return (a.double() @ w.double().t()).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul_cuda(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T as int32 by ``torch._int_mm`` on the current stream."""
    global launches
    _check(a, w)
    m, k = a.shape
    n = w.shape[0]
    kp = _round_up(k, MULTIPLE)
    mp, np_ = max(m, MIN_ROWS), _round_up(n, MULTIPLE)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    launches += 1
    return out if (mp, np_) == (m, n) else out[:m, :n]


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ w (N, K) int8 transposed -> (M, N) int32, exact:
    ``torch._int_mm`` on the card, the plain version on the CPU."""
    if a.is_cuda:
        return int8_matmul_cuda(a, w)
    return int8_matmul_plain(a, w)


def quantize(x: torch.Tensor, dims: Optional[Sequence[int]] = None):
    """Symmetric int8 of x, computed in f32: (q int8, scale f32), the scale
    reduced over ``dims`` with the dims kept (None: one per tensor)."""
    xf = x.float()
    amax = (xf.abs().amax() if dims is None
            else xf.abs().amax(dim=tuple(dims), keepdim=True))
    scale = torch.clamp_min(amax, 1e-12) * INV_127
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def taps(x: torch.Tensor, kh: int, kw: int, stride: int, pad: int):
    """The im2col gather of NHWC x: (B * Ho * Wo, kh * kw * C), taps in
    (ky, kx, c) order, and (Ho, Wo)."""
    b, h, w, c = x.shape
    if kh == kw == 1 and stride == 1 and pad == 0:
        return x.reshape(b * h * w, c), (h, w)
    xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
    # (B, Ho, Wo, C, kh, kw) windows as a view; one copy lays them out
    cols = xp.unfold(1, kh, stride).unfold(2, kw, stride)
    ho, wo = cols.shape[1:3]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, kh * kw * c), \
        (ho, wo)


def conv_acc(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int):
    """int8 NHWC xq conv int8 OIHW wq -> int32 (B, Ho, Wo, O)."""
    o, _, kh, kw = wq.shape
    a, (ho, wo) = taps(xq, kh, kw, stride, pad)
    w2 = wq.permute(0, 2, 3, 1).reshape(o, -1)
    return int8_matmul(a, w2).view(xq.shape[0], ho, wo, o)


def dequantize(acc, sx, sw, bias, dtype):
    """acc.f32 * (sx * sw) + bias.f32, in ``dtype``."""
    y = acc.float() * (sx * sw)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def out_dtype(x, *params) -> torch.dtype:
    """The promoted dtype of x and the parameters that are given."""
    dtype = x.dtype
    for p in params:
        if p is not None:
            dtype = torch.promote_types(dtype, p.dtype)
    return dtype


def upsample_kernel4(weight: torch.Tensor) -> torch.Tensor:
    """The f32 4x4 kernel (O, I, 4, 4) of ``conv3x3(nearest_up_2x(x))`` as
    one lhs-dilated conv: the JAX ``k4``, its four padded copies added in
    its order (``onedc_tpu/nn/quant.py:194-197``)."""
    k = weight.float()
    return (F.pad(k, (0, 1, 0, 1)) + F.pad(k, (0, 1, 1, 0))
            + F.pad(k, (1, 0, 0, 1)) + F.pad(k, (1, 0, 1, 0)))


def upsample_phase(xp: torch.Tensor, k4q: torch.Tensor, py: int, px: int):
    """Phase (py, px) of the upsample conv: int8 NHWC xp (B, H + 2, W + 2,
    I), the input padded by one, and int8 k4q (O, I, 4, 4) -> int32 (B, H,
    W, O), the 2x2 conv of taps (py::2, px::2)."""
    h, w = xp.shape[1] - 2, xp.shape[2] - 2
    return conv_acc(xp[:, py:py + h + 1, px:px + w + 1, :],
                    k4q[:, :, py::2, px::2], 1, 0)


# the quantized ops, each an operator: one node in an exported program

def _nchw_empty(x, b, c, h, w, dtype):
    """An NCHW tensor laid out channels_last, as the ops return."""
    return x.new_empty((b, h, w, c), dtype=dtype).permute(0, 3, 1, 2)


@torch.library.custom_op("onedc::w8a8_conv", mutates_args=())
def w8a8_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], stride: int,
              padding: int) -> torch.Tensor:
    """conv2d(x, weight, bias, stride, padding) of NCHW x in w8a8 (JAX
    ``_conv_w8a8``): one scale per image, one per output channel. Returns
    NCHW (channels_last in memory)."""
    xq, sx = quantize(x, (1, 2, 3))
    wq, sw = quantize(weight.float(), (1, 2, 3))
    acc = conv_acc(xq.permute(0, 2, 3, 1), wq, stride, padding)
    y = dequantize(acc, sx.view(-1, 1, 1, 1), sw.view(1, 1, 1, -1), bias,
                   out_dtype(x, weight))
    return y.permute(0, 3, 1, 2)


@w8a8_conv.register_fake
def _w8a8_conv_fake(x, weight, bias, stride, padding):
    b, _, h, w = x.shape
    o, _, kh, kw = weight.shape
    return _nchw_empty(x, b, o, (h + 2 * padding - kh) // stride + 1,
                       (w + 2 * padding - kw) // stride + 1,
                       out_dtype(x, weight))


@torch.library.custom_op("onedc::w8a8_dense", mutates_args=())
def w8a8_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """linear(x, weight (N, K), bias) in w8a8 (JAX ``_dense_w8a8``): one
    scale per token (row of the last dim), one per output feature."""
    xq, sx = quantize(x, (x.dim() - 1,))
    wq, sw = quantize(weight.float(), (1,))
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), wq)
    acc = acc.view(*x.shape[:-1], weight.shape[0])
    return dequantize(acc, sx, sw.view(-1), bias, out_dtype(x, weight))


@w8a8_dense.register_fake
def _w8a8_dense_fake(x, weight, bias):
    return x.new_empty((*x.shape[:-1], weight.shape[0]),
                       dtype=out_dtype(x, weight))


@torch.library.custom_op("onedc::w8a8_upsample", mutates_args=())
def w8a8_upsample(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``conv3x3(nearest_up_2x(x))`` of NCHW x in w8a8 (JAX
    ``_upsample_w8a8``). Returns NCHW (channels_last in memory)."""
    b, _, h, w = x.shape
    xq, sx = quantize(x, (1, 2, 3))
    k4q, sw = quantize(upsample_kernel4(weight), (1, 2, 3))
    xp = F.pad(xq.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    # (B, H, py, W, px, O): the phases interleaved as the output's pixels
    acc = torch.stack([torch.stack([upsample_phase(xp, k4q, py, px)
                                    for px in (0, 1)], dim=3)
                       for py in (0, 1)], dim=2)
    y = dequantize(acc, sx.view(-1, 1, 1, 1, 1, 1),
                   sw.view(1, 1, 1, 1, 1, -1), bias,
                   out_dtype(x, weight, bias))
    return y.view(b, 2 * h, 2 * w, -1).permute(0, 3, 1, 2)


@w8a8_upsample.register_fake
def _w8a8_upsample_fake(x, weight, bias):
    b, _, h, w = x.shape
    return _nchw_empty(x, b, weight.shape[0], 2 * h, 2 * w,
                       out_dtype(x, weight, bias))
