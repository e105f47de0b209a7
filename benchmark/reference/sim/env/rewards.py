"""Per-step 8-component reward (port of ``ctrl_sim_tpu/env/rewards.py``;
reference utils/sim.py:83-141 with the split collision flags):

  [0] position target achieved (sticky)  [1] heading target achieved
  [2] speed target achieved              [3] shaped position-goal reward
  [4] shaped speed-goal reward           [5] shaped heading-goal reward
  [6] vehicle-vehicle collision flag     [7] vehicle-road-edge collision flag
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.sim.config import RewardConfig
from benchmark.reference.sim.geometry import angle_sub

Tensor = torch.Tensor


def compute_reward8(
    position: Tensor,  # [..., 2]
    speed: Tensor,  # [...]
    heading: Tensor,  # [...]
    goal_position: Tensor,  # [..., 2]
    goal_speed: Tensor,  # [...]
    goal_heading: Tensor,  # [...]
    goal_dist_normalizer: Tensor,  # [...]
    prev_position_achieved: Tensor,  # [...] bool — sticky goal flag
    veh_veh_collision: Tensor,  # [...] bool
    veh_edge_collision: Tensor,  # [...] bool
    cfg: RewardConfig = RewardConfig(),
) -> tuple[Tensor, Tensor]:
    """Returns (reward8 [..., 8], new_position_achieved [...])."""
    dist_to_goal = torch.linalg.vector_norm(goal_position - position, dim=-1)
    position_achieved = prev_position_achieved | (
        dist_to_goal < cfg.position_target_tolerance
    )
    speed_achieved = (goal_speed - speed).abs() < cfg.speed_target_tolerance
    heading_achieved = (
        angle_sub(goal_heading, heading).abs() < cfg.heading_target_tolerance
    )

    scaling = cfg.shaped_goal_distance_scaling
    rs = cfg.reward_scaling
    normalizer = torch.where(
        goal_dist_normalizer == 0.0, torch.ones_like(goal_dist_normalizer),
        goal_dist_normalizer,
    )
    pos_goal_rew = torch.where(
        prev_position_achieved,
        torch.full_like(dist_to_goal, scaling / rs),
        scaling * (1.0 - dist_to_goal / normalizer) / rs,
    )
    speed_goal_rew = scaling * (1.0 - (speed - goal_speed).abs() / 40.0) / rs
    heading_goal_rew = (
        scaling * (1.0 - angle_sub(heading, goal_heading).abs() / (2.0 * math.pi)) / rs
    )
    if not (cfg.shaped_goal_distance and cfg.position_target):
        pos_goal_rew = torch.zeros_like(pos_goal_rew)
        speed_goal_rew = torch.zeros_like(speed_goal_rew)
        heading_goal_rew = torch.zeros_like(heading_goal_rew)

    f = lambda x: x.to(position.dtype)  # noqa: E731
    reward8 = torch.stack(
        [
            f(position_achieved),
            f(heading_achieved),
            f(speed_achieved),
            pos_goal_rew,
            speed_goal_rew,
            heading_goal_rew,
            f(veh_veh_collision),
            f(veh_edge_collision),
        ],
        dim=-1,
    )
    return reward8, position_achieved
