"""K1 and K1-bwd: flash attention forward and backward, hand-written CUDA
kernels for Hopper.

JAX counterparts: ``onedc_tpu/nn/attention.py:43`` (``flash_attention_tpu``,
which calls the Pallas TPU kernels of ``jax.experimental.pallas.ops.tpu.
flash_attention``: the forward ``_flash_attention_impl`` :589 and, under
``grad``, ``_flash_attention_bwd_dkv`` :941 and ``_flash_attention_bwd_dq``
:1287). Kernel sources: ``onedc_tpu_torch/csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``. On the H100 the tensor cores and, at small
head dims, the exponential unit bound them (4*N*M*H*D FLOPs and N*M*H
exponentials forward, ~10*N*M*H*D FLOPs backward, on O(N*H*D) bytes at the
UNet's shapes). Both keep the probabilities in registers, so the N x M
scores never reach device memory, and pad D inside shared memory, not in
HBM. All of them run on ``wgmma`` (bf16 operands, f32 accumulation) with
warp-specialised producers and mbarrier rings: the bf16 forward (the
decode path) loads by TMA; the f32 forward (training, with the row
log-sum-exp) and the backward (f32 on the training path, or bf16) load
rows with ordinary 16-byte loads and round f32 to bf16 as they stage it.

``flash_attention(q, k, v, scale)`` takes (B, N, H, D), (B, M, H, D),
(B, M, H, D) tensors of one dtype, bf16 or f32 (f32 operands are rounded to
bf16 in shared memory; the products accumulate in f32). For CUDA tensors it
launches the forward kernel (or raises on what the kernel does not take);
when autograd records, it goes through ``FlashAttention``, whose forward
also writes the row log-sum-exp and whose backward launches K1-bwd. For CPU
tensors it computes ``attention_plain``. There is no other route: a CUDA
tensor never reaches a plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

MAX_HEAD_DIM = 160
MAX_HEAD_DIM_BWD = 128

# launches of the CUDA kernels in this process (plain-version calls
# excluded): the forward, and the backward (one count per call of the pair
# of kernels that gives dQ and dK, dV)
launches = 0
bwd_launches = 0

_DTYPES = (torch.bfloat16, torch.float32)

_SIGNATURES = {
    "onedc_flash_attention_fwd": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]),
}
_BWD_SIGNATURES = {
    "onedc_flash_attention_bwd": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]),
}


def attention_plain(q, k, v, scale: float):
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D): f32 scores and softmax,
    probabilities cast to v's dtype (``onedc_tpu/nn/attention.py:117-120``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention_lse_plain(q, k, scale: float):
    """The row log-sum-exp of the scaled scores, (B, H, N) f32: what the
    forward kernel writes for the backward."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.logsumexp(s, dim=-1)


def attention_bwd_plain(q, k, v, out, dout, lse, scale: float):
    """(dq, dk, dv) by the explicit formulas that K1-bwd computes, in f32:
    P = exp(scale * q k^T - lse), dv = P^T dout, dP = dout v^T,
    dS = P * (dP - di) with di = rowsum(out * dout), dq = scale * dS k,
    dk = scale * dS^T q. Independent of autograd, so that it checks both
    the kernel and ``attention_plain``'s autograd."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    di = (of * dof).sum(-1).transpose(1, 2)  # (B, H, N)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, max_head_dim: int = MAX_HEAD_DIM):
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES):
        raise TypeError(f"flash_attention takes bf16 or f32 of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} disagree")
    if d % 8 or d > max_head_dim:
        raise ValueError(f"head dim {d} unsupported (multiple of 8, "
                         f"<= {max_head_dim})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")


def flash_attention_cuda(q, k, v, scale: float, with_lse: bool = False):
    """Launch K1 on q's current stream: out, or (out, lse) with
    ``with_lse``."""
    global launches
    _check(q, k, v)
    lib = load_library("flash_attention", _SIGNATURES)
    b, n, h, d = q.shape
    m = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.onedc_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, n, m, h, d, float(scale),
        int(q.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {err}")
    launches += 1
    return (out, lse) if with_lse else out


def _check_bwd(q, k, v, dout, lse, di):
    """K1-bwd's rules: the forward's, with D at most 128; dout of q's
    shape and dtype, contiguous and 16-byte aligned (its rows are read
    with 16-byte loads); lse and di (B, H, N) f32, contiguous; all on one
    device."""
    _check(q, k, v, MAX_HEAD_DIM_BWD)
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or not dout.is_contiguous() or dout.data_ptr() % 16:
        raise ValueError("dout must be contiguous, 16-byte aligned, of q's "
                         "shape and dtype")
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (q.shape[0], q.shape[2], q.shape[1]) \
                or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be (B, H, N) f32, contiguous")
    if not (dout.device == lse.device == di.device == q.device):
        raise ValueError("dout, lse, di and q on different devices")


def flash_attention_bwd_cuda(q, k, v, dout, lse, di, scale: float):
    """Launch K1-bwd (the dK/dV kernel, then the dQ kernel) on q's current
    stream: (dq, dk, dv). ``lse`` and ``di`` are (B, H, N) f32."""
    global bwd_launches
    _check_bwd(q, k, v, dout, lse, di)
    lib = load_library("flash_attention_bwd", _BWD_SIGNATURES)
    b, n, h, d = q.shape
    m = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.onedc_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, n, m, h, d, float(scale),
        int(q.dtype == torch.float32), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward launch failed: CUDA "
                           f"error {err}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 with K1-bwd as its gradient. The forward saves the row
    log-sum-exp; the backward computes di = rowsum(out * dout) in plain
    torch (as the TPU path does in plain jnp, ``flash_attention.py:273``)
    and launches K1-bwd. On CPU tensors both halves run their plain
    versions, so the tests reach this class without a card."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        if q.is_cuda:
            out, lse = flash_attention_cuda(q, k, v, scale, with_lse=True)
        else:
            out = attention_plain(q, k, v, scale)
            lse = attention_lse_plain(q, k, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if not q.is_cuda:
            return (*attention_bwd_plain(q, k, v, out, dout, lse, ctx.scale),
                    None)
        di = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
        return (*flash_attention_bwd_cuda(q, k, v, dout, lse, di, ctx.scale),
                None)


def flash_attention(q, k, v, scale: float):
    if not q.is_cuda:
        return attention_plain(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    return flash_attention_cuda(q, k, v, scale)
