"""Action / return-to-go discretization and tilt logits for the rollout.

Torch port of the parts of ``ctrl_sim_tpu/data/transforms.py`` that the
streaming rollout calls (reference: datasets/rl_waymo/dataset.py:322-387):
``discretize_actions``, ``undiscretize_actions``, ``normalize_rtgs``,
``discretize_rtgs``, ``undiscretize_rtgs``, ``get_tilt_logits`` and the
nearest-vehicle distance.
"""

from __future__ import annotations

import torch

from ctrl_sim_tpu_torch.config import WaymoDatasetConfig

Tensor = torch.Tensor


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
    device: torch.device | str = "cpu",
) -> Tensor:
    """Exponential-tilting logits per RTG bin (dataset.py:342-348):
    tilt * linspace(0, 1, num_bins) per component -> [num_bins, 3]."""
    ramp = torch.linspace(0.0, 1.0, cfg.rtg_discretization, device=device)
    return torch.stack([goal_tilt * ramp, veh_tilt * ramp, road_tilt * ramp], dim=-1)
