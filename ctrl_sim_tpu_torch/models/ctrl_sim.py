"""CtRL-Sim model, streaming interface (port of
``ctrl_sim_tpu/models/ctrl_sim.py``: ``encode_rollout_memory``,
``precompute_memory_kv``, ``stream_action_state``, ``stream_rtg`` and the
two heads). The training forward and losses are not ported yet.

Only the default CtRL-Sim family (state, rtg, action tokens) is ported:
the DT, IL and trajeglish layouts raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.device import resolve_device
from ctrl_sim_tpu_torch.models.decoder import Decoder, KVCache
from ctrl_sim_tpu_torch.models.encoder import Encoder

Tensor = torch.Tensor


class CtRLSim(nn.Module):
    """Parameters are fp32 on ``device`` (the card unless the caller passes
    ``device="cpu"``); activations run in ``model.compute_dtype``."""

    def __init__(self, cfg: Config, device: torch.device | str | None = None):
        super().__init__()
        mc = cfg.model
        if mc.trajeglish or mc.il or mc.decision_transformer or mc.ctg_plus_plus:
            raise NotImplementedError("only the default CtRL-Sim family is ported")
        device = resolve_device(device)
        self.cfg = cfg
        self.compute_dtype = getattr(torch, mc.compute_dtype)
        self.encoder = Encoder(cfg, self.compute_dtype, device)
        self.decoder = Decoder(cfg, self.compute_dtype, device)

    def _ids(self, like: Tensor, t: int) -> tuple[Tensor, Tensor]:
        """Agent ids [B, A] and a constant timestep id [B, A]."""
        B, A = like.shape[:2]
        a_ids = torch.arange(A, device=like.device).expand(B, A)
        return a_ids, torch.full((B, A), t, device=like.device, dtype=torch.long)

    def encode_rollout_memory(
        self,
        road_points: Tensor,
        road_types: Tensor,
        init_states12: Tensor,  # [B, A, 12]
        init_goals: Tensor,  # [B, A, goal_dim]
        init_exist: Tensor,  # [B, A]
        t0: int = 0,
    ) -> tuple[Tensor, Tensor]:
        """The cross-attention memory, once per episode: map polylines +
        initial-state tokens (encoder.py:155-172)."""
        a_ids, t_ids = self._ids(init_states12, t0)
        init_emb = self.encoder.embed_state_tokens(
            init_states12, init_goals, t_ids, a_ids, init_exist[..., None]
        )
        return self.encoder.encode_memory(road_points, road_types, init_emb, init_exist > 0)

    def precompute_memory_kv(self, memory: Tensor) -> list[tuple[Tensor, Tensor]]:
        return self.decoder.memory_kv(memory)

    def new_cache(self, B: int, A: int, device=None) -> KVCache:
        mc = self.cfg.model
        if mc.kv_cache_dtype != "bfloat16":
            raise NotImplementedError(
                f"model.kv_cache_dtype={mc.kv_cache_dtype!r}: the int8 cache "
                "(kernel K2) is not ported yet"
            )
        return KVCache.create(
            mc.num_decoder_layers, B, self.cfg.waymo.train_context_length, A,
            mc.num_token_types, mc.hidden_dim, self.compute_dtype, device,
        )

    def stream_action_state(
        self,
        prev_actions: Tensor,  # [B, A] discrete ids applied at step t-1
        prev_existence: Tensor,  # [B, A]
        states12: Tensor,  # [B, A, 12]
        goals: Tensor,  # [B, A, goal_dim]
        existence: Tensor,  # [B, A]
        t: int,
        cache: KVCache,
        memory_valid: Tensor,
        memory_kv: list[tuple[Tensor, Tensor]],
        mask_override: Tensor | None = None,
    ) -> tuple[Tensor, KVCache]:
        """Fused sub-pass: the previous step's action tokens and this step's
        state tokens in one decoder pass (their order is kept by the causal
        mask; at t = 0 the action group carries t = -1 and stays masked).
        Returns (state-stream outputs [B, A, H], cache)."""
        A = states12.shape[1]
        a_ids, t_prev_ids = self._ids(states12, max(t - 1, 0))
        _, t_ids = self._ids(states12, t)
        enc = self.encoder
        emb_a = enc.embed_action_tokens(prev_actions, t_prev_ids, a_ids, prev_existence[..., None])
        emb_s = enc.embed_state_tokens(states12, goals, t_ids, a_ids, existence[..., None])
        emb = enc.embed_ln(torch.cat([emb_a, emb_s], dim=1))
        mc = self.cfg.model
        x, cache = self.decoder.decode_step_groups(
            [
                (emb[:, :A], mc.num_token_types - 1, t - 1),
                (emb[:, A:], mc.state_token_index, t),
            ],
            cache, memory_valid, self.cfg.waymo.train_context_length, memory_kv,
            mask_override=mask_override,
        )
        return x[:, A:], cache

    def stream_rtg(
        self,
        rtg_bins: Tensor,  # [B, A, 3]
        existence: Tensor,
        t: int,
        cache: KVCache,
        memory_valid: Tensor,
        memory_kv: list[tuple[Tensor, Tensor]],
        mask_override: Tensor | None = None,
    ) -> tuple[Tensor, KVCache]:
        """Append this step's RTG tokens; the outputs feed the action head."""
        a_ids, t_ids = self._ids(rtg_bins, t)
        emb = self.encoder.embed_rtg_tokens(rtg_bins, t_ids, a_ids, existence[..., None])
        emb = self.encoder.embed_ln(emb)
        return self.decoder.decode_step_groups(
            [(emb, 1, t)], cache, memory_valid, self.cfg.waymo.train_context_length,
            memory_kv, mask_override=mask_override,
        )

    def rtg_head(self, x: Tensor) -> Tensor:
        return self.decoder.predict_rtg(x)

    def action_head(self, x: Tensor) -> Tensor:
        return self.decoder.predict_action(x)
