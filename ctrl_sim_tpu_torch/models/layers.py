"""Transformer building blocks (port of ``ctrl_sim_tpu/models/layers.py``).

The same computation as the JAX modules, which replicate torch's
``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer`` defaults
(post-LayerNorm, ReLU feedforward) and the reference's ``MLPLayer``. Params
are fp32; ``Dense`` and ``Embed`` compute in the config's compute dtype, as
flax's ``dtype=`` does. Submodule names follow the JAX param tree so that
``params.from_flax_params`` maps one onto the other.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ctrl_sim_tpu_torch.ops.attention import cached_decode_attention

Tensor = torch.Tensor

# torch nn.LayerNorm default eps (the reference's modules all use it)
LN_EPS = 1e-5


class Dense(nn.Linear):
    """``nn.Linear`` whose product runs in ``dtype`` (weights stay fp32)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with eps 1e-5, statistics in fp32, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype, device=None):
        super().__init__(features, eps=LN_EPS, device=device)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class Embed(nn.Embedding):
    """nn.Embedding whose rows come out in ``dtype``."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype, device=None):
        super().__init__(num_embeddings, features, device=device)
        self.compute_dtype = dtype

    def forward(self, ids: Tensor) -> Tensor:
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class MLPLayer(nn.Module):
    """Linear -> LayerNorm -> ReLU -> Linear (reference utils/layers.py:6-19)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, dtype, device=None):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim, dtype, device)
        self.norm = LayerNorm(hidden_dim, dtype, device)
        self.fc2 = Dense(hidden_dim, output_dim, dtype, device)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.relu(self.norm(self.fc1(x))))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with boolean masking (True = attend); the plain
    einsum path of the JAX module. ``score_dtype`` is the dtype of the stored
    score matrix: float32 is exact, bfloat16 rounds the stored scores and
    exp outputs while the softmax reductions stay fp32."""

    def __init__(self, d_model: int, num_heads: int, dtype, score_dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.score_dtype = score_dtype
        self.q_proj = Dense(d_model, d_model, dtype, device)
        self.k_proj = Dense(d_model, d_model, dtype, device)
        self.v_proj = Dense(d_model, d_model, dtype, device)
        self.out_proj = Dense(d_model, d_model, dtype, device)

    def forward(self, query: Tensor, key: Tensor, value: Tensor, mask=None, key_padding_mask=None) -> Tensor:
        return self.attend(query, self.k_proj(key), self.v_proj(value), mask, key_padding_mask)

    def project_qkv(self, x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """Q, K, V of the same input in one [D, 3D] product."""
        dt = self.compute_dtype
        w = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]).to(dt)
        b = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias]).to(dt)
        return F.linear(x.to(dt), w, b).chunk(3, dim=-1)

    def attend(self, query: Tensor, k: Tensor, v: Tensor, mask=None, key_padding_mask=None) -> Tensor:
        """Attention of projected ``query`` over pre-projected keys/values."""
        out = self.attend_impl(self.q_proj(query), k, v, mask, key_padding_mask)
        return self.out_proj(out)

    def attend_impl(self, q: Tensor, k: Tensor, v: Tensor, mask=None, key_padding_mask=None) -> Tensor:
        B, Tq, D = q.shape
        Tk = k.shape[1]
        hd = D // self.num_heads
        dt = self.compute_dtype
        sd = self.score_dtype
        q = q * (1.0 / math.sqrt(hd))
        q = q.reshape(B, Tq, self.num_heads, hd)
        k = k.reshape(B, Tk, self.num_heads, hd)
        v = v.reshape(B, Tk, self.num_heads, hd)
        if q.dtype == torch.bfloat16 and sd == torch.bfloat16:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k)  # fp32 accumulation
        else:
            # fp32 scores (bf16 products are exact in fp32), stored as sd
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).to(sd)
        neg = torch.finfo(sd).min
        if mask is not None:
            scores = scores.masked_fill(~mask.bool(), neg)
        if key_padding_mask is not None:
            scores = scores.masked_fill(~key_padding_mask[:, None, None, :], neg)
        if sd == torch.float32:
            weights = torch.softmax(scores, dim=-1).to(dt)
        else:
            mx = scores.amax(dim=-1, keepdim=True)
            e = torch.exp((scores - mx).float()).to(sd)
            den = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
            weights = (e / den.to(sd)).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v.to(dt))
        return out.reshape(B, Tq, D).to(dt)


class TransformerEncoderLayer(nn.Module):
    """torch nn.TransformerEncoderLayer defaults: post-LN, ReLU FF (eval mode)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, dtype, device=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype, device=device)
        self.norm1 = LayerNorm(d_model, dtype, device)
        self.linear1 = Dense(d_model, dim_feedforward, dtype, device)
        self.linear2 = Dense(dim_feedforward, d_model, dtype, device)
        self.norm2 = LayerNorm(d_model, dtype, device)

    def forward(self, src: Tensor, key_padding_mask: Tensor | None = None) -> Tensor:
        attn = self.self_attn(src, src, src, key_padding_mask=key_padding_mask)
        src = self.norm1(src + attn)
        ff = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + ff)


class TransformerDecoderLayer(nn.Module):
    """torch nn.TransformerDecoderLayer defaults: self-attn -> cross-attn -> FF,
    each with residual + post-LN; only the incremental ``decode_step`` of the
    streaming rollout is ported."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, dtype,
                 cross_score_dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype, device=device)
        self.cross_attn = MultiHeadAttention(
            d_model, num_heads, dtype, score_dtype=cross_score_dtype, device=device
        )
        self.linear1 = Dense(d_model, dim_feedforward, dtype, device)
        self.linear2 = Dense(dim_feedforward, d_model, dtype, device)
        self.norm1 = LayerNorm(d_model, dtype, device)
        self.norm2 = LayerNorm(d_model, dtype, device)
        self.norm3 = LayerNorm(d_model, dtype, device)

    def decode_step(
        self,
        tgt: Tensor,  # [B, Q, H] new tokens (Q = len(writes) * A)
        k_buf: Tensor,  # [B, W, K, A, H] this layer's ring buffer, written in place
        v_buf: Tensor,
        writes,  # sequence of (slot int, token_type int, row0 int)
        mask: Tensor,  # [Q, W*K*A] bool or int8 (nonzero = attend)
        memory_valid: Tensor,  # [B, M] bool
        mem_kv: tuple[Tensor, Tensor],  # this layer's cross-attention K/V [B, M, H]
    ) -> Tensor:
        """Cache-first incremental decode: write the new tokens' K/V into the
        ring buffer (in place: each slot's rows are overwritten, nothing
        else is copied), then attend over the whole buffer through the
        decode-attention kernel (ops/attention.py)."""
        q_new, k_new, v_new = self.self_attn.project_qkv(tgt)
        B, W, K, A, H = k_buf.shape
        for slot, token_type, row0 in writes:
            k_buf[:, slot, token_type] = k_new[:, row0 : row0 + A]
            v_buf[:, slot, token_type] = v_new[:, row0 : row0 + A]
        sa = cached_decode_attention(
            q_new.contiguous(),
            k_buf.view(B, W * K * A, H),
            v_buf.view(B, W * K * A, H),
            mask,
            self.num_heads,
        )
        x = self.norm1(tgt + self.self_attn.out_proj(sa))
        mk, mv = mem_kv
        ca = self.cross_attn.attend(x, mk, mv, key_padding_mask=memory_valid)
        x = self.norm2(x + ca)
        ff = self.linear2(F.relu(self.linear1(x)))
        return self.norm3(x + ff)
