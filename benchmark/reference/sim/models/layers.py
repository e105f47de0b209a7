"""Transformer building blocks (port of ``ctrl_sim_tpu/models/layers.py``).

The same computation as the JAX modules, which replicate torch's
``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer`` defaults
(post-LayerNorm, ReLU feedforward, dropout 0.1) and the reference's
``MLPLayer``. Params are fp32; ``Dense`` and ``Embed`` compute in the
config's compute dtype, as flax's ``dtype=`` does. Submodule names follow
the JAX param tree so that ``params.from_flax_params`` maps one onto the
other.

Dropout runs when a call passes ``deterministic=False``; its keep masks are
drawn from the caller's ``torch.Generator`` (``generator``, on the tensors'
device), the counterpart of flax's ``dropout`` RNG stream.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.sim.models.draws import plain, rand_rows, row_offset
from benchmark.reference.sim.ops.attention import cached_decode_attention
from benchmark.reference.sim.ops.flash_attention import MaskSpec, flash_mha

Tensor = torch.Tensor

# torch nn.LayerNorm default eps (the reference's modules all use it)
LN_EPS = 1e-5


def dropout(x: Tensor, rate: float, generator: torch.Generator | None) -> Tensor:
    """flax ``nn.Dropout`` in training mode: each element kept with
    probability 1 - rate (uniform draws from ``generator``), kept values
    scaled by 1 / (1 - rate), dropped ones 0. ``F.dropout`` takes no
    generator, hence the keep mask drawn here."""
    if rate <= 0.0:
        return x
    keep = rand_rows(x.shape, generator, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Linear):
    """``nn.Linear`` whose product runs in ``dtype`` (weights stay fp32).
    ``round_operands``, where set (the benchmark's lower-precision
    control), rounds the input and the weight before the product."""

    round_operands = None

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        x, w = x.to(dt), self.weight.to(dt)
        if self.round_operands is not None:
            x, w = self.round_operands(x), self.round_operands(w)
        return F.linear(x, w, self.bias.to(dt))


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


def score_scale(head_dim: int, dtype: torch.dtype) -> Tensor:
    """The attention scale folded into q, formed as the JAX layer forms it:
    1/sqrt(d) in float32, then rounded to q's dtype."""
    return (1.0 / torch.sqrt(torch.tensor(float(head_dim)))).to(dtype)


class MultiHeadAttention(nn.Module):
    """Multi-head attention with boolean masking (True = attend).

    Two routes, as in the JAX module: with a ``mask_spec`` the
    multi-agent causal self-attention of the training decoder goes through
    ``ops.flash_attention.flash_mha`` (kernels K3/K4 on the card), its
    dropout keyed by a seed drawn from the generator; otherwise the plain
    einsum path, with dropout on the attention weights. ``score_dtype`` is
    the dtype of the einsum path's stored score matrix: float32 is exact,
    bfloat16 rounds the stored scores and exp outputs while the softmax
    reductions stay fp32."""

    def __init__(self, d_model: int, num_heads: int, dtype, score_dtype=torch.float32,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.score_dtype = score_dtype
        self.dropout = dropout
        self.q_proj = Dense(d_model, d_model, dtype, device)
        self.k_proj = Dense(d_model, d_model, dtype, device)
        self.v_proj = Dense(d_model, d_model, dtype, device)
        self.out_proj = Dense(d_model, d_model, dtype, device)

    def forward(self, query: Tensor, key: Tensor, value: Tensor, mask=None, key_padding_mask=None,
                deterministic: bool = True, generator: torch.Generator | None = None,
                mask_spec: MaskSpec | None = None) -> Tensor:
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        if mask_spec is not None:
            rate = 0.0 if deterministic else self.dropout
            seed = None
            if rate > 0.0:
                seed = torch.randint(0, 2**32, (1,), generator=plain(generator), device=q.device)
            out = flash_mha(q, k, v, mask_spec, self.num_heads, rate, seed,
                            batch_offset=row_offset(generator, q.shape[0])).to(self.compute_dtype)
        else:
            out = self.attend_impl(q, k, v, mask, key_padding_mask, deterministic, generator)
        return self.out_proj(out)

    def project_qkv(self, x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """Q, K, V of the same input in one [D, 3D] product."""
        dt = self.compute_dtype
        w = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]).to(dt)
        b = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias]).to(dt)
        x = x.to(dt)
        if self.q_proj.round_operands is not None:
            x, w = self.q_proj.round_operands(x), self.q_proj.round_operands(w)
        return F.linear(x, w, b).chunk(3, dim=-1)

    def attend(self, query: Tensor, k: Tensor, v: Tensor, mask=None, key_padding_mask=None) -> Tensor:
        """Attention of projected ``query`` over pre-projected keys/values."""
        out = self.attend_impl(self.q_proj(query), k, v, mask, key_padding_mask)
        return self.out_proj(out)

    def attend_impl(self, q: Tensor, k: Tensor, v: Tensor, mask=None, key_padding_mask=None,
                    deterministic: bool = True, generator: torch.Generator | None = None) -> Tensor:
        B, Tq, D = q.shape
        Tk = k.shape[1]
        hd = D // self.num_heads
        dt = self.compute_dtype
        sd = self.score_dtype
        q = q * score_scale(hd, q.dtype)
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
        if not deterministic:
            weights = dropout(weights, self.dropout, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v.to(dt))
        return out.reshape(B, Tq, D).to(dt)


class TransformerEncoderLayer(nn.Module):
    """torch nn.TransformerEncoderLayer defaults: post-LN, ReLU FF, dropout
    after the attention, inside the FF and after it."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, dtype,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype, dropout=dropout, device=device)
        self.norm1 = LayerNorm(d_model, dtype, device)
        self.linear1 = Dense(d_model, dim_feedforward, dtype, device)
        self.linear2 = Dense(dim_feedforward, d_model, dtype, device)
        self.norm2 = LayerNorm(d_model, dtype, device)

    def forward(self, src: Tensor, key_padding_mask: Tensor | None = None,
                deterministic: bool = True, generator: torch.Generator | None = None) -> Tensor:
        drop = (lambda x: x) if deterministic else (lambda x: dropout(x, self.dropout, generator))  # noqa: E731
        attn = self.self_attn(src, src, src, key_padding_mask=key_padding_mask,
                              deterministic=deterministic, generator=generator)
        src = self.norm1(src + drop(attn))
        ff = self.linear2(drop(F.relu(self.linear1(src))))
        return self.norm2(src + drop(ff))


class TransformerDecoderLayer(nn.Module):
    """torch nn.TransformerDecoderLayer defaults: self-attn -> cross-attn -> FF,
    each with residual + post-LN and dropout. ``forward`` is the
    full-sequence training pass; ``decode_step`` the incremental decode of
    the streaming rollout."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, dtype,
                 cross_score_dtype=torch.float32, dropout: float = 0.1, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype, dropout=dropout, device=device)
        self.cross_attn = MultiHeadAttention(
            d_model, num_heads, dtype, score_dtype=cross_score_dtype, dropout=dropout, device=device
        )
        self.linear1 = Dense(d_model, dim_feedforward, dtype, device)
        self.linear2 = Dense(dim_feedforward, d_model, dtype, device)
        self.norm1 = LayerNorm(d_model, dtype, device)
        self.norm2 = LayerNorm(d_model, dtype, device)
        self.norm3 = LayerNorm(d_model, dtype, device)

    def _after_self_attn(
        self,
        tgt: Tensor,
        sa: Tensor,  # self-attention output, after its out projection
        memory: Tensor | None,
        memory_key_padding_mask: Tensor | None,
        deterministic: bool,
        generator: torch.Generator | None = None,
        mem_kv: tuple[Tensor, Tensor] | None = None,  # pre-projected cross-attention K/V
    ) -> Tensor:
        drop = (lambda x: x) if deterministic else (lambda x: dropout(x, self.dropout, generator))  # noqa: E731
        x = self.norm1(tgt + drop(sa))
        if mem_kv is not None:
            mk, mv = mem_kv
            ca = self.cross_attn.attend(x, mk, mv, key_padding_mask=memory_key_padding_mask)
        else:
            ca = self.cross_attn(x, memory, memory, key_padding_mask=memory_key_padding_mask,
                                 deterministic=deterministic, generator=generator)
        x = self.norm2(x + drop(ca))
        ff = self.linear2(drop(F.relu(self.linear1(x))))
        return self.norm3(x + drop(ff))

    def forward(
        self,
        tgt: Tensor,  # [B, N, H]
        memory: Tensor,  # [B, M, H]
        tgt_mask: Tensor | None = None,  # [N, N] bool, the plain route
        memory_key_padding_mask: Tensor | None = None,  # [B, M] bool
        deterministic: bool = True,
        tgt_mask_spec: MaskSpec | None = None,  # the flash route (kernels K3/K4)
        generator: torch.Generator | None = None,
    ) -> Tensor:
        sa = self.self_attn(tgt, tgt, tgt, mask=tgt_mask, deterministic=deterministic,
                            generator=generator, mask_spec=tgt_mask_spec)
        return self._after_self_attn(tgt, sa, memory, memory_key_padding_mask, deterministic, generator)

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
        plain decode attention (ops/attention.py, kernel K1's version)."""
        q_new, k_new, v_new = self.self_attn.project_qkv(tgt)
        B, W, K, A, H = k_buf.shape
        for slot, token_type, row0 in writes:
            k_buf[:, slot, token_type] = k_new[:, row0 : row0 + A]
            v_buf[:, slot, token_type] = v_new[:, row0 : row0 + A]
        flat_k, flat_v = k_buf.view(B, W * K * A, H), v_buf.view(B, W * K * A, H)
        sa = cached_decode_attention(q_new.contiguous(), flat_k, flat_v, mask, self.num_heads)
        return self._after_self_attn(
            tgt, self.self_attn.out_proj(sa), None, memory_valid, True, mem_kv=mem_kv
        )
