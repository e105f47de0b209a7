"""Token embedders and the scene-memory encoder (the streaming parts of
``ctrl_sim_tpu/models/encoder.py``; reference modules/encoder.py:9-178).

State+goal, return-to-go and action tokens are embedded with timestep and
agent-id embeddings; the cross-attention memory is the map polylines plus
the initial-state tokens through the transformer encoder layers. Only the
default CtRL-Sim layout (state, rtg, action) is ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    MLPLayer,
    TransformerEncoderLayer,
)
from ctrl_sim_tpu_torch.models.map_encoder import MapEncoder

Tensor = torch.Tensor


class Encoder(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype, device=None):
        super().__init__()
        mc, wc = cfg.model, cfg.waymo
        H = mc.hidden_dim
        self.cfg = cfg
        self.compute_dtype = dtype
        if mc.use_map:
            self.map_encoder = MapEncoder(cfg, dtype, device)
        self.embed_state = MLPLayer(mc.state_dim, H, H, dtype, device)
        self.embed_goal = MLPLayer(wc.goal_dim, H, H, dtype, device)
        self.embed_state_goal = Dense(2 * H, H, dtype, device)
        self.embed_action = Embed(wc.action_dim, H, dtype, device)
        self.embed_rtg_goal = Embed(wc.rtg_discretization, H, dtype, device)
        self.embed_rtg_veh = Embed(wc.rtg_discretization, H, dtype, device)
        self.embed_rtg_road = Embed(wc.rtg_discretization, H, dtype, device)
        self.embed_rtg = Dense(3 * H, H, dtype, device)
        self.embed_timestep = Embed(wc.max_timestep, H, dtype, device)
        self.embed_agent_id = Embed(wc.max_num_agents, H, dtype, device)
        self.embed_ln = LayerNorm(H, dtype, device)
        self.encoder_layers = nn.ModuleList(
            TransformerEncoderLayer(H, mc.num_heads, mc.dim_feedforward, dtype, device)
            for _ in range(mc.num_transformer_encoder_layers)
        )

    def embed_state_tokens(self, states12, goals, t_ids, agent_ids, existence) -> Tensor:
        """states12 [..., 12], goals [..., goal_dim], ids [...], existence [..., 1]."""
        dt = self.compute_dtype
        s = self.embed_state(states12.to(dt))
        g = self.embed_goal(goals.to(dt))
        out = (
            self.embed_state_goal(torch.cat([s, g], dim=-1))
            + self.embed_timestep(t_ids)
            + self.embed_agent_id(agent_ids)
        )
        return out * existence.to(dt)

    def embed_rtg_tokens(self, rtgs, t_ids, agent_ids, existence) -> Tensor:
        """rtgs [..., 3] integer bins."""
        r = rtgs.long()
        parts = [self.embed_rtg_goal(r[..., 0]), self.embed_rtg_veh(r[..., 1]), self.embed_rtg_road(r[..., 2])]
        out = (
            self.embed_rtg(torch.cat(parts, dim=-1))
            + self.embed_timestep(t_ids)
            + self.embed_agent_id(agent_ids)
        )
        return out * existence.to(self.compute_dtype)

    def embed_action_tokens(self, actions, t_ids, agent_ids, existence) -> Tensor:
        out = (
            self.embed_action(actions.long())
            + self.embed_timestep(t_ids)
            + self.embed_agent_id(agent_ids)
        )
        if self.cfg.model.no_actions:
            return out * torch.zeros_like(existence.to(self.compute_dtype))
        return out * existence.to(self.compute_dtype)

    def encode_memory(self, road_points, road_types, initial_state_emb, initial_exist):
        """Map polylines (+ initial-state tokens) through the encoder layers:
        returns (memory [B, M, H], memory_valid [B, M])."""
        mc = self.cfg.model
        if mc.use_map:
            poly_tokens, poly_valid = self.map_encoder(road_points, road_types)
            if mc.encode_initial_state:
                memory = torch.cat([poly_tokens, initial_state_emb], dim=1)
                memory_valid = torch.cat([poly_valid, initial_exist], dim=1)
            else:
                memory, memory_valid = poly_tokens, poly_valid
        else:
            memory, memory_valid = initial_state_emb, initial_exist
        for layer in self.encoder_layers:
            memory = layer(memory, key_padding_mask=memory_valid)
        return memory, memory_valid
