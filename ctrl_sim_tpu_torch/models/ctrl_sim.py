"""CtRL-Sim model and its losses (port of ``ctrl_sim_tpu/models/ctrl_sim.py``).

``CtRLSim.forward`` is the training pass over whole windows; the streaming
interface (``encode_rollout_memory``, ``precompute_memory_kv``,
``stream_action_state``, ``stream_rtg`` and the two heads) drives the
rollout. ``compute_loss`` replicates the reference's compute_loss
(models/ctrl_sim.py:48-189): masked action and RTG cross entropies and the
future-state MSE, the Python shift loop replaced by a gather.

Only the default CtRL-Sim family (state, rtg, action tokens) is ported:
the DT, IL and trajeglish layouts raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.device import resolve_device
from ctrl_sim_tpu_torch.models.decoder import Decoder, DecoderOutput, KVCache
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

    def forward(self, batch: dict, deterministic: bool = True, window: int | None = None,
                generator: torch.Generator | None = None) -> DecoderOutput:
        """Heads of every token of a batch of windows (see
        ``Encoder.forward`` for the batch); dropout and goal dropout draw
        from ``generator`` unless ``deterministic``."""
        enc = self.encoder(batch, deterministic, generator)
        return self.decoder(
            enc.stacked_embeddings, enc.encoder_embeddings, enc.memory_valid,
            num_timesteps=batch["agent_states"].shape[2], deterministic=deterministic,
            window=window, generator=generator,
        )

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


class LossDict(NamedTuple):
    total: Tensor
    loss_actions: Tensor
    loss_rtg_goal: Tensor
    loss_rtg_veh: Tensor
    loss_rtg_road: Tensor
    loss_state: Tensor


def _masked_ce(logits: Tensor, targets: Tensor, mask: Tensor) -> Tensor:
    """Cross entropy, masked mean (the reference's F.cross_entropy with
    reduction='none', then mask-sum / mask-sum)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def _shifted_futures(x: Tensor, T: int) -> tuple[Tensor, Tensor]:
    """out[..., i, j] = x[..., i+1+j] for i+1+j < T else 0 (x [B, A, T, ...]
    -> [B, A, T, T, ...]), plus the validity mask [T, T] of that triangular
    layout (ctrl_sim.py:127-138)."""
    ar = torch.arange(T, device=x.device)
    src = ar[:, None] + 1 + ar[None, :]
    in_range = src < T
    gathered = torch.index_select(x, 2, src.clamp(max=T - 1).reshape(-1))
    gathered = gathered.reshape(x.shape[:2] + (T, T) + x.shape[3:])
    m = in_range.to(x.dtype).reshape((1, 1, T, T) + (1,) * (x.dim() - 3))
    return gathered * m, in_range


def compute_loss(cfg: Config, batch: dict, preds: DecoderOutput) -> LossDict:
    mc, wc = cfg.model, cfg.waymo
    agent_states = batch["agent_states"]  # [B, A, T, 8]
    B, A, T, _ = agent_states.shape
    existence = agent_states[..., -1]
    moving = batch["moving_agent_mask"]  # [B, A]
    zero = torch.zeros((), device=agent_states.device)

    # action CE (ctrl_sim.py:50-86)
    mask = existence * moving[:, :, None] if mc.supervise_moving else existence
    loss_actions = mc.loss_action_coef * _masked_ce(preds.action_preds, batch["actions"], mask)

    # RTG CE (ctrl_sim.py:88-111), masked like the actions; logits bins-major
    loss_rtg_goal = loss_rtg_veh = loss_rtg_road = zero
    if mc.predict_rtg and preds.rtg_preds is not None:
        rp = preds.rtg_preds.reshape(B, A, T, wc.rtg_discretization, 3)
        rtgs = batch["rtgs"]
        loss_rtg_goal = _masked_ce(rp[..., 0], rtgs[..., 0], mask)
        loss_rtg_veh = _masked_ce(rp[..., 1], rtgs[..., 1], mask)
        loss_rtg_road = _masked_ce(rp[..., 2], rtgs[..., 2], mask)

    # auxiliary future-state MSE (ctrl_sim.py:114-187)
    loss_state = zero
    if mc.predict_future_states and preds.state_preds is not None:
        ex = existence * moving[:, :, None] if mc.supervise_moving else existence
        if mc.local_frame_predictions:
            # future displacements rotated into each agent's frame at time i
            fut5, in_range = _shifted_futures(agent_states[..., :5], T)
            origin = agent_states[..., :5][:, :, :, None, :]
            translated = fut5[..., :2] - origin[..., :2]
            yaw = agent_states[..., 4][:, :, :, None]
            c, s = torch.cos(yaw), torch.sin(yaw)
            fut = torch.stack([c * translated[..., 0] + s * translated[..., 1],
                               -s * translated[..., 0] + c * translated[..., 1]], dim=-1)
        else:
            fut, in_range = _shifted_futures(agent_states[..., :2], T)  # [B, A, T, T, 2]
        ex_fut, _ = _shifted_futures(ex[..., None], T)
        ex_fut = ex_fut[..., 0] * in_range[None, None]
        sp = preds.state_preds.reshape(B, A, T, T, 2).float()
        err = ((sp - fut.float()) ** 2).sum(-1)
        loss_state = (err * ex_fut).sum() / (100.0 * (ex_fut.sum() * 2.0).clamp(min=1.0))

    total = loss_actions
    if mc.predict_rtg:
        total = total + loss_rtg_goal + loss_rtg_veh + loss_rtg_road
    if mc.predict_future_states:
        total = total + loss_state
    return LossDict(total, loss_actions, loss_rtg_goal, loss_rtg_veh, loss_rtg_road, loss_state)
