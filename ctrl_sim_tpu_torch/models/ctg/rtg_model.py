"""RTG prediction head for CTG++ conditioning (port of
``ctrl_sim_tpu/models/ctg/rtg_model.py``; reference modules/rtg_model.py):
the denoiser's trunk over the past horizon only, without the diffusion
step, predicting ``rtg_discretization`` x 3 RTG logits per agent from the
present step's embedding. Built only under ``model.use_rtg``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.models.ctg.dit import DiTTrunk, MapEncoderPtsMA, SingleInputEmbedding, goal_keep
from ctrl_sim_tpu_torch.models.layers import Embed, MLPLayer

Tensor = torch.Tensor


class RTGModel(nn.Module):
    def __init__(self, cfg: Config, dtype, device=None):
        super().__init__()
        mc, wc = cfg.model, cfg.waymo
        H = mc.hidden_dim
        self.cfg = cfg
        self.compute_dtype = dtype
        self.embed_state_action = MLPLayer(wc.k_attr + wc.ctg_action_dim + wc.num_agent_types, H, H, dtype, device)
        self.embed_goal = MLPLayer(wc.goal_dim, H, H, dtype, device)
        self.embed_timestep = Embed(wc.max_timestep, H, dtype, device)
        self.embed_all_elements = MLPLayer(2 * H, H, H, dtype, device)
        self.relative_encodings_encoder = SingleInputEmbedding(7, H, dtype, device)
        self.map_encoder = MapEncoderPtsMA(cfg, dtype, device)
        self.trunk = DiTTrunk(cfg, dtype, device)
        self.predict_rtg = MLPLayer(H, H, wc.rtg_discretization * mc.num_reward_components, dtype, device)

    def forward(self, cond: dict, deterministic: bool = True, generator: torch.Generator | None = None) -> Tensor:
        """RTG logits [B, N, rtg_discretization * 3]."""
        mc = self.cfg.model
        dt = self.compute_dtype
        past_states = cond["agent_past_states"]
        B, N, T_in, _ = past_states.shape
        types = cond["agent_types"][:, :, None, :].expand(B, N, T_in, -1)
        past_sa = torch.cat([past_states[..., :-1], cond["agent_past_actions"]], dim=-1)
        seq = torch.cat([past_sa, types.to(past_sa.dtype)], dim=-1)
        exist = past_states[..., -1] > 0

        state_act_emb = self.embed_state_action(seq)
        goal_emb = self.embed_goal(cond["goals"])[:, :, None, :]
        if not deterministic and mc.goal_dropout > 0.0:
            goal_emb = goal_emb * goal_keep((B, N, 1, 1), mc.goal_dropout, generator, past_states.device).to(dt)
        goal_emb = goal_emb.expand_as(state_act_emb)
        t_emb = self.embed_timestep(cond["timesteps"][:, :T_in].long())[:, None, :, :]
        agent_emb = self.embed_all_elements(torch.cat([state_act_emb, goal_emb], dim=-1)) + t_emb

        edge_emb = self.relative_encodings_encoder(cond["past_relative_encodings"]).permute(0, 3, 1, 2, 4)
        map_features, map_valid = self.map_encoder(cond["road_points"], cond["road_types"], deterministic, generator)
        out = self.trunk(agent_emb, exist, edge_emb, map_features, map_valid, None, deterministic, generator)
        return self.predict_rtg(out[:, :, -1])


def rtg_model_loss(cfg: Config, cond: dict, logits: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Masked cross entropy of the 3 components (rtg_model.py:168-194)."""
    wc = cfg.waymo
    existence = cond["agent_past_states"][..., -1, -1].float()
    rp = logits.reshape(logits.shape[0], logits.shape[1], wc.rtg_discretization, 3).float()
    targets = cond["rtgs"][:, :, -1].long()

    def ce(component: int) -> Tensor:
        logp = F.log_softmax(rp[..., component], dim=-1)
        nll = -torch.gather(logp, -1, targets[..., component:component + 1])[..., 0]
        return (nll * existence).sum() / existence.sum().clamp(min=1.0)

    return ce(0), ce(1), ce(2)
