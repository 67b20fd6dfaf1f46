"""K1: flash attention forward, a hand-written CUDA kernel for Hopper.

JAX counterpart: ``onedc_tpu/nn/attention.py:43`` (``flash_attention_tpu``,
which calls the Pallas TPU kernel ``jax.experimental.pallas.ops.tpu.
flash_attention``). Kernel source: ``onedc_tpu_torch/csrc/flash_attention.cu``.
On the H100 the tensor cores bound it (4*N*M*H*D FLOPs on 8*N*H*D bytes at
the UNet's shapes); the kernel keeps QK^T and PV on ``mma.sync`` bf16 with
the probabilities in registers and an online softmax, so the N x M scores
never reach device memory, and pads D inside shared memory, not in HBM.

``flash_attention(q, k, v, scale)`` takes (B, N, H, D), (B, M, H, D),
(B, M, H, D) bf16 tensors. For CUDA tensors it launches the kernel (or raises
on what the kernel does not take); for CPU tensors it computes
``attention_plain``, the same function in plain PyTorch. There is no other
route: a CUDA tensor never reaches the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

MAX_HEAD_DIM = 160

# launches of the CUDA kernel in this process (plain-version calls excluded)
launches = 0

_SIGNATURES = {
    "onedc_flash_attention_fwd": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]),
}


def attention_plain(q, k, v, scale: float):
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D): f32 scores and softmax,
    probabilities cast to v's dtype (``onedc_tpu/nn/attention.py:117-120``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _check(q, k, v):
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention takes bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} disagree")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} unsupported (multiple of 8, "
                         f"<= {MAX_HEAD_DIM})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")


def flash_attention_cuda(q, k, v, scale: float):
    """Launch K1 on q's current stream."""
    global launches
    _check(q, k, v)
    lib = load_library("flash_attention", _SIGNATURES)
    b, n, h, d = q.shape
    m = k.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.onedc_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, n, m, h, d, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {err}")
    launches += 1
    return out


def flash_attention(q, k, v, scale: float):
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, scale)
    return attention_plain(q, k, v, scale)
