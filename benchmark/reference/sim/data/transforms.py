"""Training and rollout data transforms (port of
``ctrl_sim_tpu/data/transforms.py``; reference: the RLWaymoDataset
transform stack, datasets/rl_waymo/dataset.py).

Reward aggregation into the 5 training components and return-to-go,
action / RTG discretization, tilt logits, relevant-agent selection and
SE(2) scene normalization. Where the JAX functions take one scene and are
vmapped by their callers, these take a leading scene axis [E, ...] and
work on the whole batch at once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.sim.config import WaymoDatasetConfig
from benchmark.reference.sim.device import resolve_device
from benchmark.reference.sim.geometry import angle_sub, apply_se2

Tensor = torch.Tensor

# reward component indices (dataset.py:23-39)
POS_TARGET_ACHIEVED = 0
HEADING_TARGET_ACHIEVED = 1
SPEED_TARGET_ACHIEVED = 2
POS_GOAL_SHAPED = 3
SPEED_GOAL_SHAPED = 4
HEADING_GOAL_SHAPED = 5
VEH_VEH_COLLISION = 6
VEH_EDGE_COLLISION = 7


def _rtg_bounds(cfg: WaymoDatasetConfig) -> list[tuple[float, float]]:
    """(lo, hi) of the goal, vehicle and road RTG components."""
    return [
        (cfg.min_rtg_pos, cfg.max_rtg_pos),
        (cfg.min_rtg_veh, cfg.max_rtg_veh),
        (cfg.min_rtg_road, cfg.max_rtg_road),
    ]


def compute_dist_to_nearest_vehicle(position: Tensor, existence: Tensor) -> Tensor:
    """Unclipped distance to the nearest other existing vehicle, [..., A]
    (dataset.py:202-237 with ``normalize=False`` at one timestep). Agents
    with no other existing vehicle, and agents that do not exist, get 0."""
    inf = float("inf")
    masked = position.masked_fill(~existence.bool()[..., None], inf)
    diff = masked[..., :, None, :] - masked[..., None, :, :]  # [..., A, A, 2]
    sq = (diff * diff).sum(-1)
    A = position.shape[-2]
    sq = sq.masked_fill(torch.eye(A, dtype=torch.bool, device=position.device), inf)
    nearest = torch.sqrt(sq.min(dim=-1).values)
    nearest = torch.where(torch.isinf(nearest), torch.nan, nearest)
    return torch.nan_to_num(nearest * existence, nan=0.0)


def compute_dist_to_nearest_vehicle_rewards(
    positions: Tensor,  # [..., A, T, 2]
    existence: Tensor,  # [..., A, T]
    max_dist: float = 15.0,
    normalize: bool = True,
) -> Tensor:
    """Distance to the nearest other existing vehicle per agent and step,
    clipped to ``max_dist`` and divided by it (dataset.py:202-237).
    Missing timesteps, and agents with no other vehicle, give 0."""
    nearest = compute_dist_to_nearest_vehicle(positions.transpose(-2, -3), existence.transpose(-1, -2))
    nearest = nearest.transpose(-1, -2)  # [..., A, T], already existence-masked
    if normalize:
        nearest = nearest.clamp(0.0, max_dist) / max_dist
    return nearest


def compute_rewards5(
    existence: Tensor,  # [..., A, T]
    rewards8: Tensor,  # [..., A, T, 8]
    veh_edge_dist_rewards: Tensor,  # [..., A, T] (-signed_dist / 15), existence-masked
    veh_veh_dist_rewards: Tensor,  # [..., A, T] normalized nearest distance
    cfg: WaymoDatasetConfig,
) -> Tensor:
    """The 8-vector aggregated into the 5 training reward components
    (dataset.py:240-275): goal position, goal heading, goal speed,
    vehicle-vehicle (shaped distance - 10 x collision), vehicle-edge
    (clip(|dist| * 15, 0, 5) / 5 - 10 x collision)."""
    r = rewards8
    goal_pos = r[..., POS_TARGET_ACHIEVED] * cfg.pos_target_achieved_rew_multiplier
    if not cfg.remove_shaped_goal:
        goal_pos = goal_pos + (
            r[..., POS_GOAL_SHAPED].clamp(cfg.pos_goal_shaped_min, cfg.pos_goal_shaped_max)
            - cfg.pos_goal_shaped_max
        ) * (1.0 / cfg.pos_goal_shaped_max)
    goal_heading = r[..., HEADING_TARGET_ACHIEVED] + r[..., HEADING_GOAL_SHAPED]
    goal_speed = r[..., SPEED_TARGET_ACHIEVED] + r[..., SPEED_GOAL_SHAPED]
    veh_veh = -r[..., VEH_VEH_COLLISION] * cfg.veh_veh_collision_rew_multiplier
    if not cfg.remove_shaped_veh_reward:
        veh_veh = veh_veh_dist_rewards + veh_veh
    veh_edge = -r[..., VEH_EDGE_COLLISION] * cfg.veh_edge_collision_rew_multiplier
    if not cfg.remove_shaped_edge_reward:
        shaped = (veh_edge_dist_rewards.abs() * cfg.dist_to_road_edge_scaling_factor).clamp(0.0, 5.0) / 5.0
        veh_edge = shaped + veh_edge
    stacked = torch.stack([goal_pos, goal_heading, goal_speed, veh_veh, veh_edge], dim=-1)
    return stacked * existence[..., None]


def reverse_cumsum_rtg(rewards5: Tensor) -> Tensor:
    """Return-to-go: reversed cumulative sum over time
    (dataset_ctrl_sim.py:94). [..., A, T, C] -> [..., A, T, C]."""
    return torch.flip(torch.cumsum(torch.flip(rewards5, [-2]), dim=-2), [-2])


def select_rtg_components(rtgs5: Tensor) -> Tensor:
    """Keep [goal-pos, veh-veh, veh-edge] (dataset_ctrl_sim.py:99)."""
    return torch.cat([rtgs5[..., :1], rtgs5[..., 3:5]], dim=-1)


def normalize_rtgs(rtgs3: Tensor, cfg: WaymoDatasetConfig) -> Tensor:
    """Clip + min-max normalize each component to [0, 1]
    (dataset_ctrl_sim.py:100-105)."""
    return torch.stack(
        [(rtgs3[..., i].clamp(lo, hi) - lo) / (hi - lo) for i, (lo, hi) in enumerate(_rtg_bounds(cfg))],
        dim=-1,
    )


def discretize_actions(actions: Tensor, cfg: WaymoDatasetConfig) -> Tensor:
    """(accel, steer) -> single categorical in [0, 1000)
    (dataset.py:365-379). actions [..., 2] -> [...] float of integer value."""
    accel = (actions[..., 0].clamp(cfg.min_accel, cfg.max_accel) - cfg.min_accel) / (
        cfg.max_accel - cfg.min_accel
    )
    steer = (actions[..., 1].clamp(cfg.min_steer, cfg.max_steer) - cfg.min_steer) / (
        cfg.max_steer - cfg.min_steer
    )
    # torch.round rounds half to even, as jnp.round does
    accel = torch.round(accel * (cfg.accel_discretization - 1))
    steer = torch.round(steer * (cfg.steer_discretization - 1))
    return accel * cfg.steer_discretization + steer


def undiscretize_actions(actions: Tensor, cfg: WaymoDatasetConfig) -> Tensor:
    """Categorical -> continuous (accel, steer) (dataset.py:322-339)."""
    accel = torch.div(actions, cfg.steer_discretization, rounding_mode="floor").float()
    steer = torch.remainder(actions, cfg.steer_discretization).float()
    accel = accel / (cfg.accel_discretization - 1)
    steer = steer / (cfg.steer_discretization - 1)
    accel = accel * (cfg.max_accel - cfg.min_accel) + cfg.min_accel
    steer = steer * (cfg.max_steer - cfg.min_steer) + cfg.min_steer
    return torch.stack([accel, steer], dim=-1)


def discretize_rtgs(rtgs: Tensor, cfg: WaymoDatasetConfig) -> Tensor:
    """Normalized [0,1] RTGs -> bin indices (dataset.py:382-387)."""
    return torch.round(rtgs * (cfg.rtg_discretization - 1))


def undiscretize_rtgs(rtgs: Tensor, cfg: WaymoDatasetConfig) -> Tensor:
    """Bin indices -> continuous RTG values (dataset.py:351-362)."""
    frac = rtgs.float() / (cfg.rtg_discretization - 1)
    return torch.stack(
        [frac[..., i] * (hi - lo) + lo for i, (lo, hi) in enumerate(_rtg_bounds(cfg))], dim=-1
    )


def get_tilt_logits(
    goal_tilt: float, veh_tilt: float, road_tilt: float, cfg: WaymoDatasetConfig,
    device: torch.device | str | None = None,
) -> Tensor:
    """Exponential-tilting logits per RTG bin (dataset.py:342-348):
    tilt * linspace(0, 1, num_bins) per component -> [num_bins, 3], on the
    card unless ``device`` says otherwise."""
    ramp = torch.linspace(0.0, 1.0, cfg.rtg_discretization, device=resolve_device(device))
    return torch.stack([goal_tilt * ramp, veh_tilt * ramp, road_tilt * ramp], dim=-1)


# ---------------------------------------------------------------------------
# Relevant-agent selection (fixed-shape re-formulation)
# ---------------------------------------------------------------------------


class SelectedAgents(NamedTuple):
    gather_idx: Tensor  # [E, K] int64 — source agent per output slot
    slot_valid: Tensor  # [E, K] bool — slot holds a selected agent
    new_origin_idx: Tensor  # [E] int64 — origin agent's output slot


def select_relevant_agents_idx(
    agent_positions_t: Tensor,  # [E, A, 2] at the window-anchor timestep
    agent_valid: Tensor,  # [E, A] bool — real (non-padding) agents
    origin_agent_idx: Tensor,  # [E] int
    cfg: WaymoDatasetConfig,
    perm: Tensor | None = None,  # [E, K] train-time shuffle, a permutation of range(K) per scene
    keep_mask: Tensor | None = None,  # [E, A] bool — sticky relevant set (eval)
) -> SelectedAgents:
    """Fixed-shape select_relevant_agents (dataset.py:278-319): the <= K
    agents nearest to the origin agent within the distance threshold,
    nearest first, invalid slots at the back. In training ``perm`` is the
    shuffle's key (``data/pipeline.py`` draws it from its generator),
    applied as the JAX function applies its permutation: the sort is keyed
    by perm's values, which sorts the valid slots back into distance order
    whatever perm is (ROADMAP §3 keeps the question open)."""
    E, A = agent_valid.shape
    K = cfg.max_num_agents
    if A < K:
        raise ValueError(f"{A} agent slots cannot fill {K} model slots")
    origin = torch.gather(agent_positions_t, 1, origin_agent_idx.long()[:, None, None].expand(E, 1, 2))
    dist = torch.linalg.norm(agent_positions_t - origin, dim=-1)  # [E, A]
    in_range = (dist < cfg.agent_dist_threshold) & agent_valid
    if keep_mask is not None:
        in_range = in_range & keep_mask
    order = torch.sort(torch.where(in_range, dist, math.inf), dim=-1, stable=True).indices
    top = order[:, :K]
    top_valid = torch.gather(in_range, 1, top)
    if perm is not None:
        # valid entries keyed by perm's values, invalid ones after them
        perm = perm.long()
        keyed = torch.where(torch.gather(top_valid, 1, perm), perm, K + perm)
        order2 = torch.gather(perm, 1, torch.argsort(keyed, dim=-1))
        top = torch.gather(top, 1, order2)
        top_valid = torch.gather(top_valid, 1, order2)
    new_origin = (top == origin_agent_idx.long()[:, None]).int().argmax(dim=-1)
    return SelectedAgents(gather_idx=top, slot_valid=top_valid, new_origin_idx=new_origin)


def gather_agents(arr: Tensor, sel: SelectedAgents) -> Tensor:
    """Per-agent data [E, A, ...] gathered into the selected slots [E, K,
    ...], invalid slots zeroed (dataset.py:283-288)."""
    idx = sel.gather_idx.reshape(sel.gather_idx.shape + (1,) * (arr.dim() - 2))
    out = torch.gather(arr, 1, idx.expand(sel.gather_idx.shape + arr.shape[2:]))
    return out * sel.slot_valid.reshape(idx.shape).to(out.dtype)


# ---------------------------------------------------------------------------
# Scene normalization
# ---------------------------------------------------------------------------


class NormalizedScene(NamedTuple):
    agent_states: Tensor  # [E, K, T, 8]
    road_points: Tensor  # [E, P', L, 3]
    road_types: Tensor  # [E, P', 8]
    goals: Tensor  # [E, K, goal_dim]


def normalize_scene(
    agent_states: Tensor,  # [E, K, T, 8] (x, y, vx, vy, yaw, L, W, existence)
    road_points: Tensor,  # [E, P, L, 3]
    road_types: Tensor,  # [E, P, 8]
    road_valid: Tensor,  # [E, P] bool
    goals: Tensor,  # [E, K, 5]
    origin_agent_idx: Tensor,  # [E] slot of the origin agent
    cfg: WaymoDatasetConfig,
    anchor_pose: Tensor | None = None,  # [E, 3] (x, y, yaw) explicit frame anchor
) -> NormalizedScene:
    """SE(2)-normalize each scene to its origin agent at the window start,
    heading rotated to +pi/2, and keep the ``max_num_road_polylines``
    polylines whose farthest valid point is nearest (dataset.py:390-428).
    Invalid polyline rows come out as zero points and -1 types.
    ``anchor_pose`` overrides the frame anchor (episode-start
    normalization)."""
    E = agent_states.shape[0]
    if anchor_pose is None:
        first = agent_states[torch.arange(E, device=agent_states.device), origin_agent_idx.long(), 0]
        yaw, translation = first[:, 4], first[:, :2]
    else:
        yaw, translation = anchor_pose[:, 2], anchor_pose[:, :2]
    angle = (math.pi / 2) + torch.sign(-yaw) * torch.abs(yaw)  # [E]
    zero = torch.zeros_like(translation)

    def frame(x: Tensor, shift: Tensor) -> Tensor:  # x [E, ..., 2]
        return apply_se2(x, shift.reshape((E,) + (1,) * (x.dim() - 2) + (2,)), angle)

    def turn(h: Tensor) -> Tensor:  # h [E, ...]
        return angle_sub(h, -angle.reshape((E,) + (1,) * (h.dim() - 1)))

    agent_states = torch.cat([
        frame(agent_states[..., :2], translation), frame(agent_states[..., 2:4], zero),
        turn(agent_states[..., 4])[..., None], agent_states[..., 5:],
    ], dim=-1)
    goals = torch.cat([
        frame(goals[..., :2], translation), frame(goals[..., 2:4], zero), turn(goals[..., 4])[..., None],
    ], dim=-1)
    rp = torch.cat([frame(road_points[..., :2], translation), road_points[..., 2:]], dim=-1)

    # keep the polylines whose farthest valid point is nearest to the origin
    P, cap = rp.shape[1], cfg.max_num_road_polylines
    max_dist = (torch.linalg.norm(rp[..., :2], dim=-1) * rp[..., -1]).amax(dim=-1)  # [E, P]
    max_dist = torch.where(road_valid, max_dist, math.inf)
    rt, kept_valid = road_types, road_valid
    if P > cap:
        keep = torch.sort(max_dist, dim=-1, stable=True).indices[:, :cap]
        rp = torch.gather(rp, 1, keep[:, :, None, None].expand((E, cap) + tuple(rp.shape[2:])))
        rt = torch.gather(road_types, 1, keep[:, :, None].expand((E, cap) + tuple(road_types.shape[2:])))
        kept_valid = torch.gather(road_valid, 1, keep)
    rp = rp * kept_valid[:, :, None, None].to(rp.dtype)
    rt = torch.where(kept_valid[:, :, None], rt, -1.0)
    return NormalizedScene(agent_states=agent_states, road_points=rp, road_types=rt, goals=goals)
