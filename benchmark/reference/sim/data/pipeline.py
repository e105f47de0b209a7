"""Train-batch construction: offline replay arrays -> model batches (port of
``ctrl_sim_tpu/data/pipeline.py``; reference
RLWaymoDatasetCtRLSim.get_data, datasets/rl_waymo/dataset_ctrl_sim.py:38-160).

Per scene: a random 32-step window before the last existence of a moving
agent, a random moving origin agent, the <= 24 relevant agents around it
with a train-time shuffle, action / RTG discretization and SE(2)
normalization. The JAX package vmaps a per-scene function; here every step
works on the whole batch of scenes at once. The three random draws come
from a ``torch.Generator``, or are given (``TrainDraws``) so that a test
can replay the JAX draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.sim.config import Config
from benchmark.reference.sim.data import transforms as tf
from benchmark.reference.sim.data.datagen import OfflineArrays
from benchmark.reference.sim.data.scenario import Scenario

Tensor = torch.Tensor


def goals_from_scenario(scenario: Scenario) -> torch.Tensor:
    """[E, A, 5] goal vectors (x, y, vx, vy, heading) — extract_rawdata's
    goal layout (dataset.py:160-167). ``scenario`` holds tensors."""
    gp = scenario.goal_position
    gh = scenario.goal_heading
    gs = scenario.goal_speed
    return torch.cat(
        [gp, (gs * torch.cos(gh))[..., None], (gs * torch.sin(gh))[..., None], gh[..., None]],
        dim=-1,
    )


class TrainDraws(NamedTuple):
    """The random choices of one batch, per scene."""

    origin_t: Tensor  # [E] window start, uniform in [0, max_t]
    origin_agent: Tensor  # [E] origin agent, uniform over the candidates (0 if none)
    perm: Tensor  # [E, K] shuffle key of the selected slots, a permutation of range(K)


def compute_rtgs(cfg: Config, offline: OfflineArrays) -> Tensor:
    """rewards8 -> normalized 3-component RTGs [E, A, T, 3]
    (dataset_ctrl_sim.py:93-105). As in the JAX pipeline, the reversed
    cumulative sum runs over axis 1 of the batch [E, A, T, 5], the agents:
    the JAX function applies the one-scene ``reverse_cumsum_rtg`` to the
    whole batch (ROADMAP §3 keeps the question of the time axis open)."""
    rewards5 = tf.compute_rewards5(
        offline.states[..., -1], offline.rewards8, offline.veh_edge_dist_rewards,
        offline.veh_veh_dist_rewards, cfg.waymo,
    )
    rtg5 = torch.flip(torch.cumsum(torch.flip(rewards5, [1]), dim=1), [1])
    return tf.normalize_rtgs(tf.select_rtg_components(rtg5), cfg.waymo)


def build_train_sample(
    cfg: Config,
    states: Tensor,  # [E, A, T, 8] recorded replay states
    actions: Tensor,  # [E, A, T, 2]
    rtgs: Tensor,  # [E, A, T, 3] normalized
    goals: Tensor,  # [E, A, 5]
    agent_valid: Tensor,  # [E, A] bool
    road_points: Tensor,  # [E, P, L, 3]
    road_types: Tensor,  # [E, P, 8]
    road_valid: Tensor,  # [E, P] bool
    generator: torch.Generator | None = None,
    draws: TrainDraws | None = None,
    focal_idx: Tensor | None = None,  # [E] long, -1 = none (finetuning: the CAT adversary)
    supervise_focal_only: Tensor | None = None,  # [E] bool
) -> dict:
    """One training sample per scene. The finetuning options
    (dataset_ctrl_sim_finetuning.py): where ``focal_idx`` >= 0 and
    ``waymo.center_on_focal_agent``, the origin agent is the focal agent;
    where ``supervise_focal_only`` too, the loss mask
    (``moving_agent_mask``) keeps only the focal agent (:160-163)."""
    wc = cfg.waymo
    T_ctx, K = wc.train_context_length, wc.max_num_agents
    E, A, T, _ = states.shape
    dev = states.device
    existence = states[..., -1]

    # moving agents: farther than the threshold from the goal at t = 0
    dist0 = torch.linalg.norm(states[:, :, 0, :2] - goals[..., :2], dim=-1)
    moving = (dist0 > wc.moving_threshold) & agent_valid
    # agents valid for training exist at t = 0
    filtered = (existence[:, :, 0] > 0) & agent_valid

    # window start: uniform up to the last existence of a moving agent
    exists = existence > 0
    last_exist = torch.where(
        exists.any(dim=-1), (T - 1) - torch.flip(exists, [-1]).int().argmax(dim=-1), -1
    )
    max_t = (torch.where(moving, last_exist, -1).amax(dim=-1) - (T_ctx - 1)).clamp(min=0)

    def window(x: Tensor, t_idx: Tensor) -> Tensor:  # [E, A, T, C] -> [E, A, T_ctx, C]
        return torch.gather(x, 2, t_idx[:, None, :, None].expand(E, A, T_ctx, x.shape[-1]))

    u = None
    if draws is None:  # uniforms for the window start, the origin agent and the shuffle
        gdev = generator.device if generator is not None else dev
        u = torch.rand((E, 1 + A + K), generator=generator, device=gdev).to(dev)
    origin_t = (draws.origin_t.to(dev).long() if draws is not None
                else torch.minimum((u[:, 0] * (max_t + 1).float()).long(), max_t))
    t_idx = origin_t[:, None] + torch.arange(T_ctx, device=dev)
    t_safe = t_idx.clamp(max=T - 1)
    in_episode = (t_idx < T)[:, None, :, None]
    w_states = window(states, t_safe) * in_episode
    w_actions = window(actions, t_safe)
    w_rtgs = window(rtgs, t_safe)

    if draws is not None:
        origin_agent, perm = draws.origin_agent.to(dev).long(), draws.perm.to(dev).long()
    else:
        # a moving origin agent that exists at the window start (under
        # episode-start normalization: at the episode start), uniform: the
        # argmax of iid uniforms over the candidates, 0 if there is none
        cand = moving & filtered
        if not wc.episode_start_normalization:
            cand = cand & (w_states[:, :, 0, -1] > 0)
        origin_agent = torch.where(cand, u[:, 1 : 1 + A], -1.0).argmax(dim=-1)
        perm = torch.argsort(u[:, 1 + A :], dim=-1)  # the shuffle key of the selected slots
    if focal_idx is not None:
        focal = focal_idx.to(dev).long()
        use_focal = (focal >= 0) & wc.center_on_focal_agent
        origin_agent = torch.where(use_focal, focal.clamp(min=0), origin_agent)

    crop_pos = states[:, :, 0, :2] if wc.episode_start_normalization else w_states[:, :, 0, :2]
    sel = tf.select_relevant_agents_idx(crop_pos, filtered, origin_agent, wc, perm=perm)
    sel_states = tf.gather_agents(w_states, sel)
    sel_goals = tf.gather_agents(goals, sel)
    sel_moving = tf.gather_agents(moving.float(), sel)
    if focal_idx is not None and supervise_focal_only is not None:
        is_focal = (sel.gather_idx == focal.clamp(min=0)[:, None]).float() * sel.slot_valid
        only = supervise_focal_only.to(dev).bool() & (focal >= 0)
        sel_moving = torch.where(only[:, None], is_focal, sel_moving)
    anchor_pose = None
    if wc.episode_start_normalization:
        first = states[torch.arange(E, device=dev), origin_agent, 0]
        anchor_pose = torch.stack([first[:, 0], first[:, 1], first[:, 4]], dim=-1)
    norm = tf.normalize_scene(sel_states, road_points, road_types, road_valid, sel_goals,
                              sel.new_origin_idx, wc, anchor_pose=anchor_pose)
    return {
        "agent_states": norm.agent_states,  # [E, K, T_ctx, 8]
        "goals": norm.goals,  # [E, K, 5]
        "actions": tf.discretize_actions(tf.gather_agents(w_actions, sel), wc),  # [E, K, T_ctx]
        "rtgs": tf.discretize_rtgs(tf.gather_agents(w_rtgs, sel), wc),  # [E, K, T_ctx, 3]
        "timesteps": t_safe,  # [E, T_ctx]
        "moving_agent_mask": sel_moving,  # [E, K]
        "road_points": norm.road_points,  # [E, P', L, 3]
        "road_types": norm.road_types,  # [E, P', 8]
        "gather_idx": sel.gather_idx,
        "slot_valid": sel.slot_valid,
        "origin_idx": sel.new_origin_idx,
    }


def build_train_batch(
    cfg: Config,
    scenario: Scenario,
    offline: OfflineArrays,
    generator: torch.Generator | None = None,
    draws: TrainDraws | None = None,
    focal_idx: Tensor | None = None,
    supervise_focal_only: Tensor | None = None,
) -> dict:
    """A model batch of one sample per scene of ``scenario`` (tensor
    fields, one device with ``offline``), with the agent-type one-hots
    gathered into the selected slots (-1 rows where a slot is empty); the
    focal options as in ``build_train_sample``."""
    batch = build_train_sample(
        cfg, offline.states, offline.actions, compute_rtgs(cfg, offline),
        goals_from_scenario(scenario), scenario.agent_valid, scenario.road_points,
        scenario.road_types, scenario.road_valid, generator=generator, draws=draws,
        focal_idx=focal_idx, supervise_focal_only=supervise_focal_only,
    )
    n = cfg.waymo.num_agent_types
    onehot = (scenario.agent_type[..., None] == torch.arange(n, device=scenario.agent_type.device)).float()
    gathered = torch.gather(onehot, 1, batch["gather_idx"][..., None].expand(-1, -1, n))
    batch["agent_types"] = torch.where(batch["slot_valid"][..., None], gathered, -1.0)
    return batch
