"""Training attention under the multi-agent causal mask: the plain PyTorch
version of kernels K3/K4, frozen from the port's ``ops/flash_attention.py``
(dense masked attention in fp32 einsums, differentiable by autograd, and
the murmur3 dropout keep mask over (seed, batch, head, row, col) that the
kernels hash). ``flash_mha`` is the plain version on every device."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.sim.ops.masks import token_coords, visible

Tensor = torch.Tensor

_NEG = -1e30  # large-negative instead of -inf: keeps padded rows NaN-free
_U32 = 0xFFFFFFFF


class MaskSpec(NamedTuple):
    """The multi-agent causal mask, described by its layout. Token index
    j = t*(A*K) + a*K + k."""

    num_agents: int
    num_types: int
    state_index: int
    attend_own_return_action: bool
    window: int | None


def block_mask(rows: Tensor, cols: Tensor, seq_len: int, spec: MaskSpec) -> Tensor:
    """Visibility of key indices ``cols`` from query indices ``rows``
    (broadcast), plus bounds masking of rows and cols past ``seq_len``."""
    ti, ai, _ = token_coords(rows, spec.num_agents, spec.num_types)
    tj, aj, kj = token_coords(cols, spec.num_agents, spec.num_types)
    vis = visible(
        ti=ti, ai=ai, ii=rows, tj=tj, aj=aj, kj=kj, jj=cols,
        state_index=spec.state_index,
        attend_own_return_action=spec.attend_own_return_action,
        window=spec.window,
    )
    return vis & (rows < seq_len) & (cols < seq_len)


def keep_threshold(keep_prob: float) -> int:
    """The uint32 threshold under which a hash keeps its position."""
    return min(int(keep_prob * 2**32), 2**32 - 1)


def _mul32(x: Tensor, c: int) -> Tensor:
    """The low 32 bits of x * c for 0 <= x < 2^32, in int64 without
    overflow: the 16-bit halves of c each give a product below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def dropout_keep_reference(seed, b, h, rows: Tensor, cols: Tensor, keep_prob: float) -> Tensor:
    """The keep mask of the TPU kernels' ``_dropout_keep``: the murmur3
    finalizer over (seed, batch, head, row, col) in uint32 arithmetic,
    emulated in int64 with every product and xor cut to its low 32 bits.
    ``seed``, ``b`` and ``h`` are ints or int64 tensors that broadcast with
    ``rows`` and ``cols``; returns the boolean keep mask."""
    dev = rows.device
    as64 = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev) & _U32  # noqa: E731
    x = _mul32(as64(rows), 0x9E3779B1) ^ _mul32(as64(cols), 0x85EBCA77)
    x = x ^ _mul32(as64(b), 0xC2B2AE3D) ^ _mul32(as64(h), 0x27D4EB2F) ^ as64(seed)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x < keep_threshold(keep_prob)


def flash_mha_reference(
    q: Tensor,  # [B, T, D] post-projection, heads packed in D
    k: Tensor,
    v: Tensor,
    spec: MaskSpec,
    num_heads: int,
    dropout_p: float = 0.0,
    seed=None,  # int or int64 tensor [1]; only read when dropout_p > 0
    batch_offset: int = 0,  # added to the batch index in the dropout hash
) -> tuple[Tensor, Tensor]:
    """The plain PyTorch version of kernels K3/K4: dense masked attention in
    fp32 einsums. Returns (out [B, T, D] in q's dtype, lse [B, heads, T]
    fp32); differentiable by autograd, which gives K4's gradients. Row b's
    dropout mask is that of batch index ``batch_offset + b``: a rank
    holding rows [o, o + B) of a global batch passes o, and its masks are
    those of the single-process launch."""
    B, T, D = q.shape
    d = D // num_heads
    idx = torch.arange(T, device=q.device)
    mask = block_mask(idx[:, None], idx[None, :], T, spec)  # [T, T]
    qh, kh, vh = (x.float().reshape(B, T, num_heads, d) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / math.sqrt(d))
    s = torch.where(mask, s, _NEG)
    m = s.detach().amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    p = e / l
    if dropout_p > 0.0:
        kept = dropout_keep_mask(seed, batch_offset, B, num_heads, T, 1.0 - dropout_p, q.device)
        p = torch.where(kept, p / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out.reshape(B, T, D).to(q.dtype), lse


def dropout_keep_mask(seed, batch_offset: int, B: int, num_heads: int, T: int, keep_prob: float,
                      device) -> Tensor:
    """The boolean keep mask [B, heads, T, T] of a launch of B rows whose
    first row is ``batch_offset`` of the global batch (the hash's batch
    index)."""
    seed = 0 if seed is None else seed
    idx = torch.arange(T, device=device)
    heads = torch.arange(num_heads, device=device)[:, None, None]
    return torch.stack([dropout_keep_reference(seed, batch_offset + b, heads, idx[:, None], idx[None, :], keep_prob)
                        for b in range(B)])


def flash_mha(q: Tensor, k: Tensor, v: Tensor, spec: MaskSpec, num_heads: int, dropout_p: float = 0.0,
              seed=None, batch_offset: int = 0) -> Tensor:
    """``flash_mha_reference``'s output: multi-head attention under the
    mask ``spec`` with dropout keyed by (seed, batch_offset + row, head,
    query, key)."""
    return flash_mha_reference(q, k, v, spec, num_heads, dropout_p, seed, batch_offset)[0]
