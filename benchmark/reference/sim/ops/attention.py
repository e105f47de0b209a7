"""Decode attention over the streaming rollout's KV ring cache: the plain
PyTorch version of kernel K1, frozen from the port's ``ops/attention.py``.
The hand-written kernels have no place in the reference:
``cached_decode_attention`` is the plain version on every device."""

from __future__ import annotations

import torch

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


cached_decode_attention = cached_decode_attention_reference
