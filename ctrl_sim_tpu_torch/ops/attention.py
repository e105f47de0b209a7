"""Decode attention over the streaming rollout's KV ring cache (kernel K1).

Port of ``ctrl_sim_tpu/ops/attention.py:cached_decode_attention``: Q new
tokens per lane attend the flat cache [N, H] under one [Q, N] mask shared by
the batch, heads split from the packed H. On a CUDA tensor the wrapper
launches the hand-written Hopper kernel ``csrc/decode_attention.cu`` (built
by nvcc, bound with ctypes) or raises; on a CPU tensor it runs the plain
PyTorch version ``cached_decode_attention_reference``, which the CPU tests
hold against the JAX kernel and ``chip_smoke.py`` holds the CUDA kernel
against on the card.

Semantics kept from the TPU kernel: q pre-scaled by log2(e)/sqrt(d), an exp2
softmax with max subtraction and fp32 accumulation, a -1e30 bias on masked
keys (so a fully masked row comes out uniform and finite; its value is
unused), the denominator applied to the [Q, d] output. The TPU kernel's
Q-padding to 8 rows and its 128-lane concatenated store are TPU tiling
details with no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ctrl_sim_tpu_torch.ops import build

Tensor = torch.Tensor

LOG2E = 1.4426950408889634
_MASK_NEG = -1e30
HEAD_DIMS = (16, 32, 64)  # head widths the kernel is instantiated for


def _prescale(q: Tensor, num_heads: int) -> Tensor:
    head_dim = q.shape[-1] // num_heads
    return q * (LOG2E / math.sqrt(head_dim))


def cached_decode_attention_reference(
    q: Tensor,  # [B, Q, H]
    k: Tensor,  # [B, N, H]
    v: Tensor,  # [B, N, H]
    mask: Tensor,  # [Q, N] bool or int8 (nonzero = attend), shared by the batch
    num_heads: int,
) -> Tensor:
    """The plain PyTorch version of kernel K1: the same arithmetic in fp32
    einsums, output in q's dtype."""
    B, Q, H = q.shape
    N = k.shape[1]
    d = H // num_heads
    qs = _prescale(q, num_heads).float().reshape(B, Q, num_heads, d)
    kh = k.float().reshape(B, N, num_heads, d)
    vh = v.float().reshape(B, N, num_heads, d)
    bias = (1.0 - (mask != 0).float()) * _MASK_NEG  # [Q, N]
    scores = torch.einsum("bqhd,bnhd->bhqn", qs, kh) + bias
    e = torch.exp2(scores - scores.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqn,bnhd->bqhd", e, vh) / e.sum(-1).transpose(1, 2)[..., None]
    return out.reshape(B, Q, H).to(q.dtype)


def _check(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, num_heads: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or mask.dim() != 2:
        raise ValueError("expected q [B, Q, H], k/v [B, N, H], mask [Q, N]")
    B, Q, H = q.shape
    N = k.shape[1]
    if k.shape != (B, N, H) or v.shape != (B, N, H) or mask.shape != (Q, N):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, mask {tuple(mask.shape)}"
        )
    if H % num_heads != 0 or H // num_heads not in HEAD_DIMS:
        raise ValueError(f"head width H/num_heads = {H}/{num_heads} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    devices = {t.device for t in (q, k, v, mask)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and mask lie on different devices: {devices}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("decode_attention.cu").ctrl_sim_decode_attention
    fn.restype = ctypes.c_int
    # q, k, v, mask, out; B, Q, N, H, num_heads, is_bf16; stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def cached_decode_attention(
    q: Tensor,  # [B, Q, H]
    k: Tensor,  # [B, N, H]
    v: Tensor,  # [B, N, H]
    mask: Tensor,  # [Q, N] bool or int8, shared by the batch
    num_heads: int,
) -> Tensor:
    """Masked multi-head attention of Q new tokens over a decode cache.

    CUDA tensors go through the hand-written kernel (every launch adds one
    to ``cached_decode_attention.launches``); CPU tensors through the plain
    version. Any other case raises."""
    _check(q, k, v, mask, num_heads)
    if q.device.type == "cpu":
        return cached_decode_attention_reference(q, k, v, mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention for device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel loads K/V 16 bytes at a time)")
    B, Q, H = q.shape
    N = k.shape[1]
    mask_i8 = mask.to(torch.int8).contiguous()
    qs = _prescale(q, num_heads).contiguous()
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i8.data_ptr(), out.data_ptr(),
            B, Q, N, H, num_heads, int(q.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError_t {err}")
    cached_decode_attention.launches += 1
    return out


cached_decode_attention.launches = 0
