"""Decode attention over the streaming rollout's KV ring cache: kernel K1
over a bf16/f32 cache and kernel K2 over an int8 cache.

Port of ``ctrl_sim_tpu/ops/attention.py``: Q new tokens per lane attend the
flat cache [N, H] under one [Q, N] mask shared by the batch, heads split from
the packed H. ``cached_decode_attention`` (K1) takes K/V in q's dtype;
``cached_decode_attention_q8`` (K2) takes int8 K/V with fp32 per-token
scales [B, N], as ``quantize_rows`` writes them. On a CUDA tensor each
wrapper launches its hand-written Hopper kernel (``csrc/decode_attention.cu``,
``csrc/decode_attention_q8.cu``; built by nvcc, bound with ctypes) or raises:
in bf16 the tensor-core kernel (``wgmma`` fed by TMA, warp-specialised, one
pass over the cache for all of a lane's query rows; the body shared in
``csrc/decode_mma.cuh``), in f32 a CUDA-core kernel, for the 1e-4 agreement
that TF32 could not hold;
on a CPU tensor it runs its plain PyTorch version (``*_reference``), which
the CPU tests hold against the JAX kernel and ``chip_smoke.py`` holds the
CUDA kernel against on the card.

Semantics kept from the TPU kernels: q pre-scaled by log2(e)/sqrt(d), the
factor rounded to q's dtype first; an exp2 softmax with max subtraction and
fp32 accumulation; a -1e30 bias on masked keys (so a fully masked row comes
out uniform and finite; its value is unused); the weights cast to q's dtype
before the product with V; the denominator applied to the [Q, d] output.
K2 folds the K scale into the score row and the V scale into the weights,
so its products run on the raw int8 values (exact in q's dtype). The TPU
kernels' Q-padding to 8 rows and their 128-lane concatenated store are TPU
tiling details with no counterpart here. Like the JAX kernels, both take
any head width d that divides H: on the card a head narrower than an
instantiated width (``ops/heads.py``) is zero-padded to it after the
pre-scale by the true d, and a head wider than 64 raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ctrl_sim_tpu_torch.ops import build
from ctrl_sim_tpu_torch.ops.heads import head_dim, kernel_head_dim, pad_heads, unpad_heads

Tensor = torch.Tensor

LOG2E = 1.4426950408889634
_MASK_NEG = -1e30


def _prescale(q: Tensor, num_heads: int) -> Tensor:
    """q times log2(e)/sqrt(d), the factor rounded to q's dtype first, as
    the JAX wrappers do (``jnp.asarray(factor, q.dtype)``)."""
    head_dim = q.shape[-1] // num_heads
    return q * torch.tensor(LOG2E / head_dim**0.5, dtype=q.dtype)


def cached_decode_attention_reference(
    q: Tensor,  # [B, Q, H]
    k: Tensor,  # [B, N, H]
    v: Tensor,  # [B, N, H]
    mask: Tensor,  # [Q, N] bool or int8 (nonzero = attend), shared by the batch
    num_heads: int,
) -> Tensor:
    """The plain PyTorch version of kernel K1: the same arithmetic in fp32
    einsums, the weights rounded to q's dtype before the product with V as
    the TPU kernel rounds them, output in q's dtype."""
    B, Q, H = q.shape
    N = k.shape[1]
    d = H // num_heads
    qs = _prescale(q, num_heads).float().reshape(B, Q, num_heads, d)
    kh = k.float().reshape(B, N, num_heads, d)
    vh = v.float().reshape(B, N, num_heads, d)
    bias = (1.0 - (mask != 0).float()) * _MASK_NEG  # [Q, N]
    scores = torch.einsum("bqhd,bnhd->bhqn", qs, kh) + bias
    e = torch.exp2(scores - scores.amax(dim=-1, keepdim=True))
    out = torch.einsum("bhqn,bnhd->bqhd", e.to(q.dtype).float(), vh) / e.sum(-1).transpose(1, 2)[..., None]
    return out.reshape(B, Q, H).to(q.dtype)


def _check(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, num_heads: int, scales: tuple = ()) -> None:
    """The shapes, q dtype and device that both kernels take; the heads
    must divide H."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or mask.dim() != 2:
        raise ValueError("expected q [B, Q, H], k/v [B, N, H], mask [Q, N]")
    B, Q, H = q.shape
    N = k.shape[1]
    if (k.shape != (B, N, H) or v.shape != (B, N, H) or mask.shape != (Q, N)
            or any(s.shape != (B, N) for s in scales)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"mask {tuple(mask.shape)}, scales {[tuple(s.shape) for s in scales]}"
        )
    head_dim(H, num_heads)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    devices = {t.device for t in (q, k, v, mask, *scales)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v, mask and scales lie on different devices: {devices}")


@functools.lru_cache(maxsize=None)
def _kernel(source: str, symbol: str, pointers: int):
    fn = getattr(build.load(source), symbol)
    fn.restype = ctypes.c_int
    # pointers (q, k, v[, k_scale, v_scale], mask, out); B, Q, N, H, num_heads, is_bf16; stream
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def _launch(fn, q: Tensor, k: Tensor, v: Tensor, mask: Tensor, num_heads: int, scales: tuple = ()) -> Tensor:
    """Launches one decode-attention kernel on q's current stream and
    returns its output; raises on what the kernel does not take. Heads
    narrower than an instantiated width are zero-padded to it (q after its
    pre-scale by the true width), and the padded output columns dropped."""
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention for device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), *zip(("k_scale", "v_scale"), scales)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels load K/V by TMA and 16-byte copies)")
    B, Q, H = q.shape
    N = k.shape[1]
    d = H // num_heads
    width = kernel_head_dim(d)
    mask_i8 = mask.to(torch.int8).contiguous()
    if N % 2:  # the kernels take mask rows of even length: pad
        mask_i8 = torch.nn.functional.pad(mask_i8, (0, 1))
    qs = pad_heads(_prescale(q, num_heads), num_heads, width).contiguous()
    k, v = pad_heads(k, num_heads, width), pad_heads(v, num_heads, width)
    out = torch.empty_like(qs)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            qs.data_ptr(), *(t.data_ptr() for t in (k, v, *scales)), mask_i8.data_ptr(), out.data_ptr(),
            B, Q, N, num_heads * width, num_heads, int(q.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError_t {err}")
    return unpad_heads(out, num_heads, d)


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
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.device.type == "cpu":
        return cached_decode_attention_reference(q, k, v, mask, num_heads)
    out = _launch(_kernel("decode_attention.cu", "ctrl_sim_decode_attention", 5), q, k, v, mask, num_heads)
    cached_decode_attention.launches += 1
    return out


cached_decode_attention.launches = 0


def quantize_rows(x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-token symmetric int8 quantization over the last axis: returns
    (int8 values, fp32 scales) with x ~= values * scales[..., None];
    scale = max(max|x| / 127, 1e-12), values = clip(round(x / scale), +-127),
    rounding half to even as ``jnp.round`` does."""
    xf = x.float()
    # divide by a tensor on x's device, not a Python number: CUDA divides
    # by a CPU scalar through its reciprocal, one rounding more than the
    # quotient the JAX package takes
    s = torch.clamp_min(xf.abs().amax(dim=-1) / torch.full((), 127.0, device=x.device), 1e-12)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def cached_decode_attention_q8_reference(
    q: Tensor,  # [B, Q, H] float32 or bfloat16
    k: Tensor,  # [B, N, H] int8
    v: Tensor,  # [B, N, H] int8
    k_scale: Tensor,  # [B, N] fp32 per-token scales
    v_scale: Tensor,  # [B, N] fp32
    mask: Tensor,  # [Q, N] bool or int8 (nonzero = attend), shared by the batch
    num_heads: int,
) -> Tensor:
    """The plain PyTorch version of kernel K2, with the TPU body's roundings:
    fp32 scores of q against the int8 K times ``k_scale`` plus the -1e30
    bias, exp2 against the row max, the weights times ``v_scale`` rounded to
    q's dtype before the product with the int8 V, fp32 accumulation divided
    by the fp32 denominator; output in q's dtype."""
    B, Q, H = q.shape
    N = k.shape[1]
    d = H // num_heads
    qs = _prescale(q, num_heads).float().reshape(B, Q, num_heads, d)
    kh = k.float().reshape(B, N, num_heads, d)  # int8 values are exact in any float type
    vh = v.float().reshape(B, N, num_heads, d)
    bias = (1.0 - (mask != 0).float()) * _MASK_NEG  # [Q, N]
    scores = torch.einsum("bqhd,bnhd->bhqn", qs, kh) * k_scale[:, None, None, :] + bias
    e = torch.exp2(scores - scores.amax(dim=-1, keepdim=True))
    wv = (e * v_scale[:, None, None, :]).to(q.dtype).float()
    out = torch.einsum("bhqn,bnhd->bqhd", wv, vh) / e.sum(-1).transpose(1, 2)[..., None]
    return out.reshape(B, Q, H).to(q.dtype)


def cached_decode_attention_q8(
    q: Tensor,  # [B, Q, H] float32 or bfloat16
    k: Tensor,  # [B, N, H] int8
    v: Tensor,  # [B, N, H] int8
    k_scale: Tensor,  # [B, N] fp32
    v_scale: Tensor,  # [B, N] fp32
    mask: Tensor,  # [Q, N] bool or int8, shared by the batch
    num_heads: int,
) -> Tensor:
    """Masked multi-head attention of Q new tokens over an int8 decode cache.

    CUDA tensors go through the hand-written kernel (every launch adds one
    to ``cached_decode_attention_q8.launches``); CPU tensors through the
    plain version. Any other case raises."""
    _check(q, k, v, mask, num_heads, (k_scale, v_scale))
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"k/v must be int8, got {k.dtype}/{v.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {k_scale.dtype}/{v_scale.dtype}")
    if q.device.type == "cpu":
        return cached_decode_attention_q8_reference(q, k, v, k_scale, v_scale, mask, num_heads)
    fn = _kernel("decode_attention_q8.cu", "ctrl_sim_decode_attention_q8", 7)
    out = _launch(fn, q, k, v, mask, num_heads, (k_scale, v_scale))
    cached_decode_attention_q8.launches += 1
    return out


cached_decode_attention_q8.launches = 0
