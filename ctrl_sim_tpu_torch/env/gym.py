"""Gym-style partially observable replay: the consumer of
``WaymoEnv.observe`` (port of ``ctrl_sim_tpu/env/gym.py``).

Nocturne's RL interface hands agents an ego-centric visible state each step
(scenario.cc:391-548 through the ``nocturne.envs`` wrappers). This module
log-replays every agent through physics and emits the fixed-shape
observation stream an RL consumer would train on, batched over scenes.
Each step keeps only its outputs, so the occlusion's intermediates of one
step are freed before the next.

Example
-------
    obs, traj = observation_replay(cfg, scenario, ego_index)
    obs["visible_objects"]  # [T, E, max_visible_objects, 13]
"""

from __future__ import annotations

import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.env.dynamics import inverse_bicycle_action
from ctrl_sim_tpu_torch.env.env import WaymoEnv
from ctrl_sim_tpu_torch.env.observation import VIEW_ANGLE

Tensor = torch.Tensor


@torch.no_grad()
def observation_replay(
    cfg: Config,
    scenario: Scenario,  # tensors on one device (data.to_torch)
    ego_index: Tensor,  # [E] int — ego agent per scene
    max_visible_objects: int = 16,
    max_visible_lights: int = 20,
    max_visible_road_points: int = 300,
    max_visible_stop_signs: int = 4,
    view_dist: float = 80.0,
    view_angle: float = VIEW_ANGLE,
) -> tuple[dict, dict]:
    """Replay the GT actions through physics, observing through the ego's
    cone at each of ``cfg.sim.steps`` steps, before the step.

    Returns ``(obs, traj)``, time-major: obs holds ``ego_state`` [T, E, 5],
    ``visible_mask`` [T, E, A], ``visible_objects`` [T, E, K, 13],
    ``road_points`` [T, E, K, 13], ``traffic_lights`` [T, E, K, 12] and
    ``stop_signs`` [T, E, K, 3] (``WaymoEnv.observe``); traj holds
    ``position`` [T, E, A, 2] and ``reward8`` [T, E, A, 8], the privileged
    stream underneath."""
    env = WaymoEnv(cfg)
    tp, th, ts, tv = scenario.traj_position, scenario.traj_heading, scenario.traj_speed, scenario.traj_valid
    last = tp.shape[2] - 1  # a physics-dialect scene holds one state fewer: the index clamps, as in jit
    state = env.reset(scenario)
    streams: dict[str, list] = {}
    positions, rewards = [], []
    for t in range(cfg.sim.steps):
        reward8, state = env.reward(scenario, state)
        obs = env.observe(
            scenario, state, ego_index,
            max_visible_objects=max_visible_objects, max_visible_lights=max_visible_lights,
            max_visible_road_points=max_visible_road_points, max_visible_stop_signs=max_visible_stop_signs,
            view_dist=view_dist, view_angle=view_angle,
        )
        for key, value in obs.items():
            streams.setdefault(key, []).append(value)
        positions.append(state.bodies.position)
        rewards.append(reward8)
        nt = min(t + 1, last)
        b = state.bodies
        accel, steer = inverse_bicycle_action(
            tp[:, :, nt], th[:, :, nt], ts[:, :, nt], b.position, b.heading, b.speed,
            scenario.length, cfg.sim.dt,
        )
        valid = state.alive & tv[:, :, min(t, last)] & tv[:, :, nt]
        zero = torch.zeros_like(accel)
        state = env.step(
            scenario, state, torch.where(valid, accel, zero), torch.where(valid, steer, zero),
            expert_mask=torch.zeros_like(valid), alive_next=valid,
        )
    obs = {key: torch.stack(values) for key, values in streams.items()}
    return obs, {"position": torch.stack(positions), "reward8": torch.stack(rewards)}
