"""Rollout outputs and helpers shared with the exact-mode rollout (the parts
of ``ctrl_sim_tpu/rollout/rollout.py`` that ``run_streaming`` calls; the
exact-mode ``run_closed_loop`` is not ported yet)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data import transforms as tf
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.env.env import EnvState
from ctrl_sim_tpu_torch.geometry import signed_distance_to_polylines
from ctrl_sim_tpu_torch.rollout.groups import GroupSpec, packed_trivial_groups, trivial_groups

Tensor = torch.Tensor


class RolloutOutput(NamedTuple):
    """Stacked per-step streams, time-major [T(+1), E, A, ...]."""

    position: Tensor
    velocity: Tensor
    heading: Tensor
    speed: Tensor
    existence: Tensor
    reward8: Tensor
    acceleration: Tensor  # [T, E, A]
    steering: Tensor
    nearest_dist: Tensor  # [T+1, E, A]
    rtgs: Tensor  # [T, E, A, 3] continuous sampled RTGs
    controlled_mask: Tensor  # [E, A]


def _nearest_dist(position: Tensor, existence: Tensor) -> Tensor:
    """Unclipped nearest-vehicle distance at one timestep [E, A]
    (evaluator.py:87-103)."""
    return tf.compute_dist_to_nearest_vehicle(position, existence)


def dt_dense_reward3(cfg: Config, scenario: Scenario, env_state: EnvState, reward8: Tensor) -> Tensor:
    """Per-step dense 3-component reward of the DT policy's real-time RTG
    decay (evaluator.py:106-140): goal achieved, shaped nearest-vehicle
    distance minus collision, shaped road-edge distance minus collision."""
    wc = cfg.waymo
    ex_now = env_state.alive.float()
    nearest_now = _nearest_dist(env_state.bodies.position, ex_now)
    veh_dist = (nearest_now * ex_now).clamp(0.0, wc.max_veh_veh_distance) / wc.max_veh_veh_distance
    signed = signed_distance_to_polylines(
        env_state.bodies.position, scenario.edge_polylines, scenario.edge_poly_valid
    )
    dense_goal = reward8[..., 0] * wc.pos_target_achieved_rew_multiplier
    dense_veh = veh_dist - reward8[..., 6] * wc.veh_veh_collision_rew_multiplier
    dense_edge = (
        signed.abs().clamp(0.0, 5.0) / 5.0
        - reward8[..., 7] * wc.veh_edge_collision_rew_multiplier
    )
    return torch.stack([dense_goal, dense_veh, dense_edge], dim=-1) * ex_now[..., None]


def select_focal_agents(scenario: Scenario, controlled_mask: Tensor) -> Tensor:
    """Origin agent per lane: the controlled vehicle with the longest GT
    existence (autoregressive_policy.py:88-94); ties go to the lowest index."""
    lengths = scenario.traj_valid.sum(dim=2)
    keyed = torch.where(controlled_mask, lengths, -1)
    return torch.argmax(keyed, dim=1)


def default_groups(
    cfg: Config,
    scenario: Scenario,
    controlled_mask: Tensor,
    crop_size: int | None = None,
) -> GroupSpec:
    """Single-group spec for scenes already at the crop size; ``crop_size``
    below the scene's agent count packs the crop_size closest in-range
    agents into the leading model slots (groups.packed_trivial_groups)."""
    wc = cfg.waymo
    tp = scenario.traj_position
    if crop_size is None and tp.shape[1] != wc.max_num_agents:
        raise ValueError(
            f"scenes with {tp.shape[1]} agent slots need focal groups or packed "
            f"slots: max_num_agents={wc.max_num_agents}"
        )
    origin_idx = select_focal_agents(scenario, controlled_mask)
    pos0 = tp[:, :, 0]
    origin_pos0 = torch.gather(pos0, 1, origin_idx[:, None, None].expand(-1, 1, 2))
    dist0 = torch.linalg.vector_norm(pos0 - origin_pos0, dim=-1)
    relevant0 = (
        (dist0 < wc.agent_dist_threshold) & scenario.agent_valid & scenario.traj_valid[:, :, 0]
    )
    gt_length = scenario.traj_valid.sum(dim=2)
    if crop_size is not None and crop_size != tp.shape[1]:
        return packed_trivial_groups(
            cfg, origin_idx, relevant0, controlled_mask, gt_length, dist0, crop_size
        )
    return trivial_groups(cfg, origin_idx, relevant0, controlled_mask, gt_length)
