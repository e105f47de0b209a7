"""Offline-RL dataset generation: batched replay through physics (port of
``ctrl_sim_tpu/data/datagen.py``; reference
data/generate_offline_rl_dataset.py).

Every vehicle of every scene is simulated and driven by inverse-bicycle
actions re-derived each step from the simulated (drifting) state toward the
ground-truth next state (reference :88-119); per-step states, actions and
8-component rewards are recorded, then the two distance-shaped reward
streams the preprocessed pickles carry (dataset.py:189-237): signed
distance to the nearest road edge and distance to the nearest vehicle. A
Python loop over steps takes the place of ``lax.scan``. The env resolves
vehicle contacts when ``sim.resolve_contacts`` is on (the default).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.data.transforms import compute_dist_to_nearest_vehicle_rewards
from ctrl_sim_tpu_torch.env.dynamics import inverse_bicycle_action
from ctrl_sim_tpu_torch.env.env import WaymoEnv
from ctrl_sim_tpu_torch.geometry import signed_distance_to_polylines

Tensor = torch.Tensor

EDGE_CHUNK = 16  # scenes per signed-distance pass: bounds its [E, K, N, S] temporaries


class OfflineArrays(NamedTuple):
    """Recorded replay streams, the array form of the *_physics.json +
    preprocessed pickle pair."""

    states: Tensor  # [E, A, T, 8] (x, y, vx, vy, yaw, L, W, existence)
    actions: Tensor  # [E, A, T, 2] (accel, steer)
    rewards8: Tensor  # [E, A, T, 8]
    veh_edge_dist_rewards: Tensor  # [E, A, T] (-signed_dist / 15, existence-masked)
    veh_veh_dist_rewards: Tensor  # [E, A, T] (normalized nearest distance)


@torch.no_grad()
def generate_offline_data(cfg: Config, scenario: Scenario) -> OfflineArrays:
    """Replay a batch of scenes (tensor fields, ``data.to_torch``) through
    physics and record everything, on the scenes' device."""
    env = WaymoEnv(cfg)
    tp, th, ts, tv = (scenario.traj_position, scenario.traj_heading, scenario.traj_speed,
                      scenario.traj_valid)
    length, width = scenario.length, scenario.width
    state = env.reset(scenario)
    states, actions, rewards = [], [], []
    for t in range(cfg.sim.steps):
        bodies = state.bodies
        # inverse-bicycle action from the simulated state toward GT next
        accel, steer = inverse_bicycle_action(
            tp[:, :, t + 1], th[:, :, t + 1], ts[:, :, t + 1],
            bodies.position, bodies.heading, bodies.speed, length, cfg.sim.dt,
        )
        # an action is valid iff GT exists at t and t+1 and the chain is unbroken
        act_valid = state.alive & tv[:, :, t] & tv[:, :, t + 1]
        accel = torch.where(act_valid, accel, 0.0)
        steer = torch.where(act_valid, steer, 0.0)

        reward8, state = env.reward(scenario, state)
        bodies = state.bodies
        heading = bodies.heading
        velocity = bodies.speed[..., None] * torch.stack([torch.cos(heading), torch.sin(heading)], -1)
        states.append(torch.cat([
            bodies.position, velocity, heading[..., None], length.expand_as(heading)[..., None],
            width.expand_as(heading)[..., None], act_valid[..., None].to(tp.dtype),
        ], dim=-1))  # the pre-step state in the dataset convention
        actions.append(torch.stack([accel, steer], dim=-1))
        rewards.append(reward8)
        state = env.step(scenario, state, accel, steer, expert_mask=torch.zeros_like(act_valid),
                         alive_next=act_valid)

    states = torch.stack(states, dim=2)
    existence = states[..., -1]
    E, A, T = existence.shape
    pos = states[..., :2].reshape(E, A * T, 2)
    dist = torch.cat([
        signed_distance_to_polylines(pos[i : i + EDGE_CHUNK], scenario.edge_polylines[i : i + EDGE_CHUNK],
                                     scenario.edge_poly_valid[i : i + EDGE_CHUNK])
        for i in range(0, E, EDGE_CHUNK)
    ]).reshape(E, A, T)
    veh_edge = (-dist / cfg.waymo.dist_to_road_edge_scaling_factor) * existence
    veh_veh = compute_dist_to_nearest_vehicle_rewards(states[..., :2], existence,
                                                      cfg.waymo.max_veh_veh_distance)
    # the reference masks both streams by existence once more (dataset_ctrl_sim.py:61-62)
    return OfflineArrays(
        states=states,
        actions=torch.stack(actions, dim=2),
        rewards8=torch.stack(rewards, dim=2),
        veh_edge_dist_rewards=veh_edge * existence,
        veh_veh_dist_rewards=veh_veh * existence,
    )
