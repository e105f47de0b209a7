"""CTG++ denoiser (port of ``ctrl_sim_tpu/models/ctg/dit.py``; reference
modules/ctg_arch.py): an AutoBots-style trunk of temporal attention per
agent over time, relative social attention between agents (dense
edge-biased attention with a gated update) and per-agent map
cross-attention, with a sinusoidal diffusion-step embedding, ending in an
MLP that emits each future step's local state (5) and action (2).

The attentions are plain torch, as they are plain ``jnp`` in the JAX
package: the trunk calls ``MultiHeadAttention`` without a ``mask_spec``.
Submodule names follow the JAX param tree (``params.from_flax_params``).

The map features and the edge embedding depend on the conditioning alone,
not on the noisy future or the diffusion step: ``DiT.encode_context``
computes them once, and ``forward`` takes them as ``context``, so that a
sampling loop encodes them once and not at each of its denoiser calls.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.models.draws import rand_rows
from ctrl_sim_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    MLPLayer,
    MultiHeadAttention,
    TransformerEncoderLayer,
    dropout,
)

Tensor = torch.Tensor

# the reference's 8 pooling heads (ctg_arch.py:290), whatever model.num_heads is
MAP_POOL_HEADS = 8


def sinusoidal_pos_emb(x: Tensor, dim: int) -> Tensor:
    """SinusoidalPosEmb (utils/diffusion_helpers.py:15-27); the frequency
    denominator is ``half - 1``."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=x.device, dtype=torch.float32) * (-math.log(10000.0) / (half - 1)))
    emb = x[..., None] * freqs
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def positional_encoding_table(max_len: int, d_model: int, device=None) -> Tensor:
    """The fixed sin/cos positional table (ctg_arch.py:29-45), [max_len, d_model]."""
    position = torch.arange(max_len, device=device, dtype=torch.float32)[:, None]
    div = torch.exp(
        torch.arange(0, d_model, 2, device=device, dtype=torch.float32) * (-math.log(10000.0) / d_model)
    )
    pe = torch.zeros((max_len, d_model), device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


class SingleInputEmbedding(nn.Module):
    """3 x (Linear-LN), ReLU after the first two (ctg_arch.py:196-213); the
    flax module's auto names."""

    def __init__(self, in_dim: int, out_dim: int, dtype, device=None):
        super().__init__()
        for i in range(3):
            self.add_module(f"Dense_{i}", Dense(in_dim if i == 0 else out_dim, out_dim, dtype, device))
            self.add_module(f"LayerNorm_{i}", LayerNorm(out_dim, dtype, device))

    def forward(self, x: Tensor) -> Tensor:
        for i in range(3):
            x = getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x))
            if i < 2:
                x = F.relu(x)
        return x


class RelativeSocialAttention(nn.Module):
    """Edge-feature-biased dense attention with a gated update
    (ctg_arch.py:48-193). For target i over sources j (the full graph with
    self, masked by validity):

      alpha_ij = softmax_j(q_i . (k_node_j + k_edge_ij) / sqrt(d_h))
      m_i      = sum_j alpha_ij (v_node_j + v_edge_ij)
      gate     = sigmoid(lin_ih(m_i) + lin_hh(x_i))
      upd_i    = m_i + gate * (lin_self(x_i) - m_i)
      x        = norm2(x' + mlp(norm1(x'))),  x' = x + out_proj(upd)

    A row with no valid key gets alpha 0, not the NaN of a softmax over
    nothing (those agents are masked downstream)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, dtype, dropout: float = 0.1,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.compute_dtype = dtype
        for name in ("lin_q_node", "lin_k_node", "lin_v_node", "lin_k_edge", "lin_v_edge", "lin_ih", "lin_hh",
                     "lin_self", "out_proj"):
            self.add_module(name, Dense(d_model, d_model, dtype, device))
        self.norm1 = LayerNorm(d_model, dtype, device)
        self.mlp_lin1 = Dense(d_model, dim_feedforward, dtype, device)
        self.mlp_lin2 = Dense(dim_feedforward, d_model, dtype, device)
        self.norm2 = LayerNorm(d_model, dtype, device)

    def forward(self, x: Tensor, edge_emb: Tensor, valid: Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> Tensor:
        """x [B, N, H]; edge_emb [B, N, N, H] (edge_emb[i, j]: j -> i);
        valid [B, N] bool."""
        B, N, D = x.shape
        h, hd = self.num_heads, D // self.num_heads
        drop = (lambda y: y) if deterministic else (lambda y: dropout(y, self.dropout, generator))  # noqa: E731
        q = self.lin_q_node(x).reshape(B, N, h, hd)
        k = self.lin_k_node(x).reshape(B, 1, N, h, hd) + self.lin_k_edge(edge_emb).reshape(B, N, N, h, hd)
        v = self.lin_v_node(x).reshape(B, 1, N, h, hd) + self.lin_v_edge(edge_emb).reshape(B, N, N, h, hd)
        # fp32 scores (bf16 products are exact in fp32), as preferred_element_type does
        scores = torch.einsum("bihd,bijhd->bijh", q.float(), k.float()) / math.sqrt(hd)
        mask = (valid[:, :, None] & valid[:, None, :])[..., None]
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
        alpha = torch.softmax(scores, dim=2)
        alpha = torch.where(mask.any(dim=2, keepdim=True), alpha, 0.0)
        alpha = drop(alpha)
        m = torch.einsum("bijh,bijhd->bihd", alpha, v.float()).reshape(B, N, D).to(self.compute_dtype)
        gate = torch.sigmoid(self.lin_ih(m) + self.lin_hh(x))
        upd = m + gate * (self.lin_self(x) - m)
        x = x + drop(self.out_proj(upd))
        y = self.mlp_lin2(drop(F.relu(self.mlp_lin1(self.norm1(x)))))
        return self.norm2(x + drop(y))


class MapEncoderPtsMA(nn.Module):
    """Per-agent road-segment encoder (ctg_arch.py:262-337): per (agent,
    polyline) learned-seed attention pooling over the 2-d points, with 8
    heads whatever ``model.num_heads`` is, fused with road-type features."""

    def __init__(self, cfg: Config, dtype, device=None):
        super().__init__()
        mc = cfg.model
        H = mc.hidden_dim
        self.dropout = mc.dropout
        self.compute_dtype = dtype
        self.road_pts_lin = Dense(2, H, dtype, device)
        self.map_seeds = nn.Parameter(torch.zeros((1, 1, H), device=device))
        self.road_pts_attn_layer = MultiHeadAttention(H, MAP_POOL_HEADS, dtype, dropout=mc.dropout, device=device)
        self.norm1 = LayerNorm(H, dtype, device)
        self.map_feats_lin1 = Dense(H, 3 * H, dtype, device)
        self.map_feats_lin2 = Dense(3 * H, H, dtype, device)
        self.norm2 = LayerNorm(H, dtype, device)
        self.road_type_lin = Dense(8, H, dtype, device)
        self.road_pt_type_mlp_lin1 = Dense(2 * H, 3 * H, dtype, device)
        self.road_pt_type_mlp_lin2 = Dense(3 * H, H, dtype, device)

    def forward(self, road_points: Tensor, road_types: Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> tuple[Tensor, Tensor]:
        """road_points [B, M, S, P, 3]; road_types [B, M, S, 8] ->
        (features [B, M, S, H], seg_valid [B, M, S])."""
        dt = self.compute_dtype
        B, M, S, P, _ = road_points.shape
        H = self.map_seeds.shape[-1]
        drop = (lambda y: y) if deterministic else (lambda y: dropout(y, self.dropout, generator))  # noqa: E731
        point_valid = road_points[..., -1] > 0.0
        seg_valid = point_valid.any(dim=-1)
        # NaN guards (ctg_arch.py:303-305): a segment with no valid point
        # attends to its first; an agent with no valid segment keeps its first
        point_valid = torch.cat([point_valid[..., :1] | ~seg_valid[..., None], point_valid[..., 1:]], dim=-1)
        has_road = seg_valid.any(dim=-1)
        seg_valid = torch.cat([seg_valid[..., :1] | ~has_road[..., None], seg_valid[..., 1:]], dim=-1)

        pts = self.road_pts_lin(road_points[..., :2]).reshape(B * M * S, P, H)
        seed = self.map_seeds.to(dt).expand(B * M * S, 1, H)
        pooled = self.road_pts_attn_layer(seed, pts, pts, key_padding_mask=point_valid.reshape(B * M * S, P),
                                          deterministic=deterministic, generator=generator)
        pooled = self.norm1(pooled)
        ff = self.map_feats_lin2(drop(F.relu(self.map_feats_lin1(pooled))))
        pooled = self.norm2(pooled + ff).reshape(B, M, S, H)

        fused = torch.cat([pooled, self.road_type_lin(road_types)], dim=-1)
        fused = self.road_pt_type_mlp_lin2(drop(F.relu(self.road_pt_type_mlp_lin1(fused))))
        return fused, seg_valid


class DiTTrunk(nn.Module):
    """The interleaved temporal / social / map attention stack shared by the
    denoiser and the RTG model (ctg_arch.py:389-409, rtg_model.py:66-82):
    per layer two temporal encoder layers, one social layer and one map
    cross-attention, the diffusion-step embedding added at each layer."""

    def __init__(self, cfg: Config, dtype, device=None):
        super().__init__()
        mc = cfg.model
        H = mc.hidden_dim
        self.num_layers = mc.num_transformer_encoder_layers
        self.compute_dtype = dtype
        for i in range(self.num_layers):
            for j in range(2):
                self.add_module(f"temporal_{i}_{j}", TransformerEncoderLayer(
                    H, mc.num_heads, mc.dim_feedforward, dtype, mc.dropout, device))
            self.add_module(f"social_{i}", RelativeSocialAttention(
                H, mc.num_heads, mc.dim_feedforward, dtype, mc.dropout, device))
            self.add_module(f"map_attn_{i}", MultiHeadAttention(H, mc.num_heads, dtype, dropout=mc.dropout,
                                                                device=device))
        self.register_buffer("pe", positional_encoding_table(100, H, device), persistent=False)

    def forward(
        self,
        agent_emb: Tensor,  # [B, N, T, H]
        exist: Tensor,  # [B, N, T] bool
        edge_emb: Tensor,  # [B, T, N, N, H]
        map_features: Tensor,  # [B, N, S, H]
        map_valid: Tensor,  # [B, N, S]
        diff_step_emb: Tensor | None = None,  # [B, H]
        deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> Tensor:
        dt = self.compute_dtype
        B, N, T, H = agent_emb.shape
        S = map_features.shape[2]
        pe = self.pe[:T].to(dt)
        # NaN guard: a fully missing agent attends to its last step
        t_valid = exist.clone()
        t_valid[..., -1] |= ~exist.any(dim=-1)
        kpm = t_valid.reshape(B * N, T)
        ee = edge_emb.reshape(B * T, N, N, H)
        sv = exist.transpose(1, 2).reshape(B * T, N)
        mf = map_features.reshape(B * N, S, H)
        mv = map_valid.reshape(B * N, S)
        x = agent_emb
        for i in range(self.num_layers):
            if diff_step_emb is not None:
                x = x + diff_step_emb[:, None, None, :].to(dt)
            xt = (x + pe).reshape(B * N, T, H)
            for j in range(2):
                xt = getattr(self, f"temporal_{i}_{j}")(xt, key_padding_mask=kpm, deterministic=deterministic,
                                                        generator=generator)
            xs = xt.reshape(B, N, T, H).transpose(1, 2).reshape(B * T, N, H)
            xs = getattr(self, f"social_{i}")(xs, ee, sv, deterministic, generator)
            x = xs.reshape(B, T, N, H).transpose(1, 2)
            delta = getattr(self, f"map_attn_{i}")(x.reshape(B * N, T, H), mf, mf, key_padding_mask=mv,
                                                   deterministic=deterministic, generator=generator)
            x = x + delta.reshape(B, N, T, H)
        return x


class DiTContext(NamedTuple):
    """What the denoiser computes from the conditioning alone."""

    edge_emb: Tensor  # [B, T_in + T_out, N, N, H]
    map_features: Tensor  # [B, N, S, H]
    map_valid: Tensor  # [B, N, S] bool


def goal_keep(shape: tuple, rate: float, generator: torch.Generator | None, device) -> Tensor:
    """The train-time goal dropout's keep mask: uniform > rate."""
    return rand_rows(shape, generator, device) > rate


class DiT(nn.Module):
    """The CTG++ denoiser (ctg_arch.py:340-511). The 9-wide future layout is
    local state (5), then width and length from the present step, then the
    action (2)."""

    def __init__(self, cfg: Config, dtype, device=None):
        super().__init__()
        mc, wc = cfg.model, cfg.waymo
        H = mc.hidden_dim
        self.cfg = cfg
        self.compute_dtype = dtype
        self.tgt_k = wc.k_attr - 2
        self.embed_state_action = MLPLayer(self.tgt_k + 2 + wc.ctg_action_dim + wc.num_agent_types, H, H, dtype, device)
        self.embed_goal = MLPLayer(wc.goal_dim, H, H, dtype, device)
        self.embed_timestep = Embed(wc.max_timestep, H, dtype, device)
        if mc.use_rtg:
            for name in ("embed_rtg_goal", "embed_rtg_veh", "embed_rtg_road"):
                self.add_module(name, Embed(wc.rtg_discretization, H, dtype, device))
            self.embed_rtg = Dense(3 * H, H, dtype, device)
        self.embed_all_elements = MLPLayer((3 if mc.use_rtg else 2) * H, H, H, dtype, device)
        self.diffusion_step_encoder = MLPLayer(H, H, H, dtype, device)
        self.relative_encodings_encoder = SingleInputEmbedding(7, H, dtype, device)
        self.map_encoder = MapEncoderPtsMA(cfg, dtype, device)
        self.trunk = DiTTrunk(cfg, dtype, device)
        self.output_mlp = MLPLayer(H, H, self.tgt_k + wc.ctg_action_dim, dtype, device)

    def encode_context(self, cond: dict, deterministic: bool = True,
                       generator: torch.Generator | None = None) -> DiTContext:
        rel = torch.cat([cond["past_relative_encodings"], cond["future_relative_encodings"]], dim=3)
        edge_emb = self.relative_encodings_encoder(rel).permute(0, 3, 1, 2, 4)  # [B, T, N, N, H]
        map_features, map_valid = self.map_encoder(cond["road_points"], cond["road_types"], deterministic,
                                                   generator)
        return DiTContext(edge_emb, map_features, map_valid)

    def forward(
        self,
        future_k: Tensor,  # [B, N, T_out, 7] noisy (state 5 + action 2)
        cond: dict,
        diffusion_step: Tensor,  # [B]
        deterministic: bool = True,
        generator: torch.Generator | None = None,
        context: DiTContext | None = None,
    ) -> Tensor:
        mc = self.cfg.model
        dt = self.compute_dtype
        past_states, past_actions = cond["agent_past_states"], cond["agent_past_actions"]
        B, N, T_in, _ = past_states.shape
        T_out = future_k.shape[2]
        tgt_k = self.tgt_k

        types = cond["agent_types"][:, :, None, :].expand(B, N, T_in + T_out, -1)
        width_length = past_states[:, :, -1:, 5:7].expand(B, N, T_out, 2)
        future_sa = torch.cat([future_k[..., :tgt_k], width_length, future_k[..., tgt_k:]], dim=-1)
        past_sa = torch.cat([past_states[..., :-1], past_actions], dim=-1)
        past_exist = past_states[..., -1] > 0
        exist = torch.cat([past_exist, past_exist[:, :, -1:].expand(B, N, T_out)], dim=-1)
        seq = torch.cat([torch.cat([past_sa, future_sa], dim=2), types.to(past_sa.dtype)], dim=-1)

        state_act_emb = self.embed_state_action(seq)
        goal_emb = self.embed_goal(cond["goals"])[:, :, None, :]
        if not deterministic and mc.goal_dropout > 0.0:
            keep = goal_keep((B, N, 1, 1), mc.goal_dropout, generator, future_k.device)
            goal_emb = goal_emb * keep.to(dt)
        goal_emb = goal_emb.expand_as(state_act_emb)
        # every step carries the present step's timestep (dataset_ctg_plus_plus.py:335)
        t_emb = self.embed_timestep(cond["timesteps"].long())[:, None, :, :]
        parts = [state_act_emb, goal_emb]
        if mc.use_rtg:
            r = cond["rtgs"][:, :, -1].long()
            rtg = torch.cat([self.embed_rtg_goal(r[..., 0]), self.embed_rtg_veh(r[..., 1]),
                             self.embed_rtg_road(r[..., 2])], dim=-1)
            parts.append(self.embed_rtg(rtg)[:, :, None, :].expand_as(state_act_emb))
        agent_emb = self.embed_all_elements(torch.cat(parts, dim=-1)) + t_emb

        diff_emb = self.diffusion_step_encoder(sinusoidal_pos_emb(diffusion_step.float(), mc.hidden_dim).to(dt))
        if context is None:
            context = self.encode_context(cond, deterministic, generator)
        out = self.trunk(agent_emb, exist, context.edge_emb, context.map_features, context.map_valid, diff_emb,
                         deterministic, generator)
        return self.output_mlp(out[:, :, T_in:])
