"""Tokenizer and scene encoder (port of ``ctrl_sim_tpu/models/encoder.py``;
reference modules/encoder.py:9-178).

State+goal, return-to-go and action tokens are embedded with timestep and
agent-id embeddings; the cross-attention memory is the map polylines plus
the initial-state tokens through the transformer encoder layers. The
streaming rollout calls the embedders and ``encode_memory`` one step at a
time; training calls ``forward``, which builds the interleaved token
sequence of a whole window in the family's layout: (state, rtg, action) for
CtRL-Sim, (rtg, state, action) for DT, whose returns are continuous and
embedded by dense layers, (state, action) for IL and the actions alone for
trajeglish.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from benchmark.reference.sim.config import Config
from benchmark.reference.sim.models.layers import (
    Dense,
    Embed,
    LayerNorm,
    MLPLayer,
    TransformerEncoderLayer,
)
from benchmark.reference.sim.models.draws import rand_rows
from benchmark.reference.sim.models.map_encoder import MapEncoder

Tensor = torch.Tensor


class SceneEncoding(NamedTuple):
    stacked_embeddings: Tensor  # [B, T*A*K, H] decoder target sequence
    encoder_embeddings: Tensor  # [B, P(+A), H] cross-attention memory
    memory_valid: Tensor  # [B, P(+A)] bool


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
        for name in ("embed_rtg_goal", "embed_rtg_veh", "embed_rtg_road"):
            setattr(self, name, Dense(1, H, dtype, device) if mc.decision_transformer
                    else Embed(wc.rtg_discretization, H, dtype, device))
        self.embed_rtg = Dense(3 * H, H, dtype, device)
        self.embed_timestep = Embed(wc.max_timestep, H, dtype, device)
        self.embed_agent_id = Embed(wc.max_num_agents, H, dtype, device)
        self.embed_ln = LayerNorm(H, dtype, device)
        self.encoder_layers = nn.ModuleList(
            TransformerEncoderLayer(H, mc.num_heads, mc.dim_feedforward, dtype, mc.dropout, device)
            for _ in range(mc.num_transformer_encoder_layers)
        )

    def embed_state_tokens(self, states12, goals, t_ids, agent_ids, existence, goal_keep=None) -> Tensor:
        """states12 [..., 12], goals [..., goal_dim], ids [...], existence
        [..., 1]; ``goal_keep`` [..., 1] is the train-time goal dropout."""
        dt = self.compute_dtype
        s = self.embed_state(states12.to(dt))
        g = self.embed_goal(goals.to(dt))
        if goal_keep is not None:
            g = g * goal_keep.to(dt)
        out = (
            self.embed_state_goal(torch.cat([s, g], dim=-1))
            + self.embed_timestep(t_ids)
            + self.embed_agent_id(agent_ids)
        )
        return out * existence.to(dt)

    def embed_rtg_tokens(self, rtgs, t_ids, agent_ids, existence) -> Tensor:
        """rtgs [..., 3]: integer bins, or for DT continuous values (taken
        as floats, training's bins included)."""
        if self.cfg.model.decision_transformer:
            r = rtgs.to(self.compute_dtype)
            parts = [self.embed_rtg_goal(r[..., 0:1]), self.embed_rtg_veh(r[..., 1:2]),
                     self.embed_rtg_road(r[..., 2:3])]
        else:
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

    def encode_memory(self, road_points, road_types, initial_state_emb, initial_exist,
                      deterministic: bool = True, generator: torch.Generator | None = None):
        """Map polylines (+ initial-state tokens) through the encoder layers:
        returns (memory [B, M, H], memory_valid [B, M])."""
        mc = self.cfg.model
        if mc.use_map:
            poly_tokens, poly_valid = self.map_encoder(road_points, road_types, deterministic, generator)
            if mc.encode_initial_state:
                memory = torch.cat([poly_tokens, initial_state_emb], dim=1)
                memory_valid = torch.cat([poly_valid, initial_exist], dim=1)
            else:
                memory, memory_valid = poly_tokens, poly_valid
        else:
            memory, memory_valid = initial_state_emb, initial_exist
        for layer in self.encoder_layers:
            memory = layer(memory, key_padding_mask=memory_valid, deterministic=deterministic,
                           generator=generator)
        return memory, memory_valid

    def forward(self, batch: dict, deterministic: bool = True,
                generator: torch.Generator | None = None) -> SceneEncoding:
        """The training encoding of a batch of windows: ``agent_states``
        [B, A, T, 8], ``agent_types`` [B, A, 5], ``goals`` [B, A, 5],
        ``actions`` [B, A, T], ``rtgs`` [B, A, T, 3], ``timesteps`` [B, T],
        ``road_points`` [B, P, L, 3], ``road_types`` [B, P, 8]. Unless
        ``deterministic``, goal dropout hides an agent's goal at every step
        (one draw per agent) and the layers' dropout runs."""
        mc, wc = self.cfg.model, self.cfg.waymo
        H = mc.hidden_dim
        agent_states = batch["agent_states"]
        B, A, T, _ = agent_states.shape
        dev = agent_states.device
        existence = agent_states[..., -1:]  # [B, A, T, 1]

        def tflat(x: Tensor) -> Tensor:  # [B, A, T, ...] -> [B, T*A, ...]
            return x.transpose(1, 2).reshape((B, T * A) + tuple(x.shape[3:]))

        types = batch["agent_types"][:, :, None, :].expand(B, A, T, wc.num_agent_types)
        states12 = torch.cat([agent_states[..., :-1], types.to(agent_states.dtype)], dim=-1)
        goals = batch["goals"][:, :, None, : wc.goal_dim].expand(B, A, T, wc.goal_dim)
        t_ids = tflat(batch["timesteps"][:, None, :].expand(B, A, T)).long()
        a_ids = tflat(torch.arange(A, device=dev)[None, :, None].expand(B, A, T))
        ex = tflat(existence)

        goal_keep = None
        if not deterministic and mc.goal_dropout > 0.0:
            keep = rand_rows((B, A), generator, dev) > mc.goal_dropout
            goal_keep = keep[:, None, :].expand(B, T, A).reshape(B, T * A, 1)

        state_emb = self.embed_state_tokens(tflat(states12), tflat(goals), t_ids, a_ids, ex, goal_keep)
        rtg_emb = self.embed_rtg_tokens(tflat(batch["rtgs"]), t_ids, a_ids, ex)
        action_emb = self.embed_action_tokens(tflat(batch["actions"]), t_ids, a_ids, ex)
        if mc.decision_transformer:
            parts = [rtg_emb, state_emb, action_emb]
        elif mc.trajeglish:
            parts = [action_emb]
        elif mc.il:
            parts = [state_emb, action_emb]
        else:
            parts = [state_emb, rtg_emb, action_emb]
        tokens = self.embed_ln(torch.stack(parts, dim=2).reshape(B, T * A * len(parts), H))

        initial_state_emb = state_emb.reshape(B, T, A, H)[:, 0]
        initial_exist = ex.reshape(B, T, A)[:, 0] > 0
        memory, memory_valid = self.encode_memory(
            batch["road_points"], batch["road_types"], initial_state_emb, initial_exist,
            deterministic, generator,
        )
        return SceneEncoding(tokens, memory, memory_valid)
