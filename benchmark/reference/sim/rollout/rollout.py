"""The outputs and the helpers of the streaming rollout
(``rollout/streaming.py``), frozen from the port's ``rollout/rollout.py``
without its exact-mode rollout, which no cell runs: the applied actions
(the policy's after the history, ground-truth replay otherwise), the
step records, the tilts and DT's real-time returns."""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.sim.config import Config
from benchmark.reference.sim.data import transforms as tf
from benchmark.reference.sim.data.scenario import Scenario
from benchmark.reference.sim.env.dynamics import inverse_bicycle_action
from benchmark.reference.sim.env.env import EnvState, WaymoEnv
from benchmark.reference.sim.geometry import signed_distance_to_polylines
from benchmark.reference.sim.rollout.groups import (
    GroupSpec,
    packed_trivial_groups,
    trivial_groups,
)

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


def initial_real_time_rtgs(cfg: Config, controlled_mask: Tensor) -> Tensor:
    """The DT policy's real-time returns at t = 0 (policy_evaluator.py:
    123-145), [E, A, 3]: the largest achievable (10, 90, 90), or (0, -10,
    -10) for the evaluated vehicles under ``policy.min_return``."""
    dev = controlled_mask.device
    rtg = torch.tensor([10.0, 90.0, 90.0], device=dev).expand(controlled_mask.shape + (3,))
    if cfg.policy.min_return:
        rtg = torch.where(controlled_mask[..., None], torch.tensor([0.0, -10.0, -10.0], device=dev), rtg)
    return rtg


def agent_tilts(cfg: Config, controlled_mask: Tensor, tilt_logits: Tensor | None) -> Tensor:
    """Tilt logits per agent [E, A, bins, 3]: ``tilt_logits`` [bins, 3] on
    the controlled agents and zero elsewhere, or given per agent (the
    planner-vs-adversary evaluator tilts ego and adversary apart)."""
    if tilt_logits is None:
        tilt_logits = torch.zeros((cfg.waymo.rtg_discretization, 3), device=controlled_mask.device)
    if tilt_logits.dim() == 2:
        return torch.where(controlled_mask[..., None, None], tilt_logits, 0.0)
    return tilt_logits


def applied_actions(
    cfg: Config, scenario: Scenario, env_state: EnvState, t: int, controlled_mask: Tensor,
    policy_actions: Tensor,  # [E, A, 2]
) -> tuple[Tensor, Tensor, Tensor]:
    """(accel, steer, alive_next) of step t: the policy's action for a live
    controlled agent from ``history_steps - 1`` on (policy_evaluator.py:534),
    the inverse-bicycle action toward the next GT pose for every other
    agent (zero where that pose or the current one is missing,
    evaluator.py:160-193); replay agents die one step early."""
    tp, th, ts, tv = (scenario.traj_position, scenario.traj_heading, scenario.traj_speed,
                      scenario.traj_valid)
    bodies = env_state.bodies
    gt_accel, gt_steer = inverse_bicycle_action(
        tp[:, :, t + 1], th[:, :, t + 1], ts[:, :, t + 1],
        bodies.position, bodies.heading, bodies.speed, scenario.length, cfg.sim.dt,
    )
    replay_valid = env_state.alive & tv[:, :, t] & tv[:, :, t + 1]
    gt_accel = torch.where(replay_valid, gt_accel, 0.0)
    gt_steer = torch.where(replay_valid, gt_steer, 0.0)
    use_policy = controlled_mask & env_state.alive & (t >= cfg.sim.history_steps - 1)
    accel = torch.where(use_policy, policy_actions[..., 0], gt_accel)
    steer = torch.where(use_policy, policy_actions[..., 1], gt_steer)
    alive_next = env_state.alive & tv[:, :, t + 1] & (use_policy | replay_valid)
    return accel, steer, alive_next


def step_record(env_state: EnvState, reward8: Tensor, accel: Tensor, steer: Tensor,
                rtg_cont: Tensor) -> tuple:
    """One step's row of the output streams, from the pre-step state."""
    bodies, exist = env_state.bodies, env_state.alive.float()
    return (bodies.position, bodies.velocity, bodies.heading, bodies.speed, exist, reward8,
            accel, steer, _nearest_dist(bodies.position, exist), rtg_cont)


def finish_rollout(env: WaymoEnv, scenario: Scenario, env_state: EnvState, rows: list,
                   controlled_mask: Tensor) -> RolloutOutput:
    """The stacked streams, with the final state's record appended to the
    [T+1] streams (policy_evaluator.py:544-556)."""
    final_reward8, final = env.reward(scenario, env_state)
    cols = list(zip(*rows))
    exist = final.alive.float()
    last = (final.bodies.position, final.bodies.velocity, final.bodies.heading,
            final.bodies.speed, exist, final_reward8)
    stacked = [torch.stack(list(c) + [x]) for c, x in zip(cols[:6], last)]
    return RolloutOutput(
        *stacked,
        acceleration=torch.stack(cols[6]),
        steering=torch.stack(cols[7]),
        nearest_dist=torch.stack(list(cols[8]) + [_nearest_dist(final.bodies.position, exist)]),
        rtgs=torch.stack(cols[9]),
        controlled_mask=controlled_mask,
    )


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
