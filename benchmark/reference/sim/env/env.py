"""The batched driving environment (port of ``ctrl_sim_tpu/env/env.py``).

One ``WaymoEnv.step`` advances every agent of every scene in lockstep, with
the reference's semantics: FreeCar physics or kinematic bicycle for
controlled agents, expert log-replay teleport (scenario.cc:277-283), dead
agents pinned at the (-1e6, -1e6) sentinel, collision flags recomputed after
the dynamics, and the sticky position-goal bit carried in the state. With
``sim.resolve_contacts`` (the default) and physics dynamics, the Box2D-style
contact solver (env/contacts.py) corrects FreeCar's velocities and
re-integrates, in b2World::Step order.

Unlike the JAX ``step``, which also returns a ``StepOutput``, the port's
``step`` returns the new state alone: its callers read the streams from
the state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.sim.config import Config
from benchmark.reference.sim.data.scenario import DEAD_POSITION, Scenario
from benchmark.reference.sim.env.collision import detect_collisions
from benchmark.reference.sim.env.contacts import resolve_contacts
from benchmark.reference.sim.env.dynamics import (
    BodyState,
    body_state_from_pose,
    freecar_step,
    kinematic_bicycle_step,
)
from benchmark.reference.sim.env.rewards import compute_reward8

Tensor = torch.Tensor


class EnvState(NamedTuple):
    """Dynamic state of a batch of scenes. All tensors lead with [E, A]."""

    bodies: BodyState
    t: int  # current timestep (same across envs)
    veh_veh_collision: Tensor  # [E, A] bool
    veh_edge_collision: Tensor  # [E, A] bool
    position_achieved: Tensor  # [E, A] bool — sticky goal bit
    alive: Tensor  # [E, A] bool — existence chain


class WaymoEnv:
    """Batched environment over a ``Scenario`` whose fields are tensors."""

    def __init__(self, cfg: Config):
        if cfg.sim.dynamics not in ("physics", "kinematic"):
            raise ValueError(f"unknown dynamics contract {cfg.sim.dynamics!r}")
        self.cfg = cfg

    def reset(self, scenario: Scenario, start_time: int = 0) -> EnvState:
        """Bodies from the GT trajectory at ``start_time``, then the initial
        collision pass (scenario.cc:254-258)."""
        bodies = body_state_from_pose(
            scenario.traj_position[:, :, start_time],
            scenario.traj_heading[:, :, start_time],
            scenario.traj_speed[:, :, start_time],
        )
        alive = scenario.traj_valid[:, :, start_time] & scenario.agent_valid
        veh_veh, veh_edge = self._collisions(scenario, bodies)
        return EnvState(
            bodies=bodies,
            t=start_time,
            veh_veh_collision=veh_veh,
            veh_edge_collision=veh_edge,
            position_achieved=torch.zeros_like(alive),
            alive=alive,
        )

    def _collisions(self, scenario: Scenario, bodies: BodyState):
        return detect_collisions(
            bodies.position, bodies.heading, scenario.length, scenario.width,
            scenario.agent_valid, scenario.edge_seg_p0, scenario.edge_seg_p1,
            scenario.edge_seg_valid,
        )

    def reward(self, scenario: Scenario, state: EnvState) -> tuple[Tensor, EnvState]:
        """The 8-component reward at the current state; updates the sticky
        goal bit (called before stepping, policy_evaluator.py:515)."""
        veh_veh = state.veh_veh_collision
        veh_edge = state.veh_edge_collision
        if not self.cfg.sim.collision_fix:
            # legacy merged flag: an edge collision masks the vehicle report
            veh_veh = veh_veh & ~veh_edge
        reward8, position_achieved = compute_reward8(
            state.bodies.position,
            state.bodies.speed,
            state.bodies.heading,
            scenario.goal_position,
            scenario.goal_speed,
            scenario.goal_heading,
            scenario.goal_dist_normalizer,
            state.position_achieved,
            veh_veh,
            veh_edge,
            self.cfg.sim.rewards,
        )
        return reward8, state._replace(position_achieved=position_achieved)

    def step(
        self,
        scenario: Scenario,
        state: EnvState,
        acceleration: Tensor,  # [E, A]
        steering: Tensor,  # [E, A]
        expert_mask: Tensor,  # [E, A] bool — log-replay teleport agents
        alive_next: Tensor,  # [E, A] bool — existence after this transition
    ) -> EnvState:
        """Advance all scenes by dt; returns the new state."""
        sim = self.cfg.sim
        bodies = state.bodies
        t_next = state.t + 1

        if sim.dynamics == "physics":
            stepped = freecar_step(
                bodies, acceleration, steering, scenario.length, sim.dt, sim.physics
            )
            if sim.resolve_contacts:
                # b2World::Step order: FreeCar proposes velocities, the
                # contact solver corrects them, then positions integrate
                valid = scenario.agent_valid
                stepped = resolve_contacts(
                    bodies, stepped, scenario.length, scenario.width,
                    state.alive & valid & ~expert_mask, state.alive & valid & expert_mask, sim.dt,
                )
        else:
            new_pos, new_heading, new_speed = kinematic_bicycle_step(
                bodies.position, bodies.heading, bodies.speed, acceleration,
                steering, scenario.length, sim.dt,
            )
            stepped = BodyState(
                position=new_pos,
                heading=new_heading,
                speed=new_speed,
                velocity=new_speed[..., None]
                * torch.stack([torch.cos(new_heading), torch.sin(new_heading)], -1),
                angular_velocity=torch.zeros_like(bodies.angular_velocity),
                throttle_accel=bodies.throttle_accel,
                brake_accel=bodies.brake_accel,
            )

        # expert log-replay teleport: GT pose at the new time
        t_idx = min(t_next, scenario.traj_position.shape[2] - 1)
        gt = body_state_from_pose(
            scenario.traj_position[:, :, t_idx],
            scenario.traj_heading[:, :, t_idx],
            scenario.traj_speed[:, :, t_idx],
        )
        em = expert_mask
        zero = torch.zeros_like(stepped.speed)
        merged = BodyState(
            position=torch.where(em[..., None], gt.position, stepped.position),
            heading=torch.where(em, gt.heading, stepped.heading),
            speed=torch.where(em, gt.speed, stepped.speed),
            velocity=torch.where(em[..., None], gt.velocity, stepped.velocity),
            angular_velocity=torch.where(em, gt.angular_velocity, stepped.angular_velocity),
            throttle_accel=torch.where(em, zero, stepped.throttle_accel),
            brake_accel=torch.where(em, zero, stepped.brake_accel),
        )

        # dead agents: pin to the sentinel (autoregressive_policy.py:263)
        dead = ~alive_next
        merged = BodyState(
            position=torch.where(
                dead[..., None], torch.full_like(merged.position, DEAD_POSITION),
                merged.position,
            ),
            heading=merged.heading,
            speed=torch.where(dead, zero, merged.speed),
            velocity=torch.where(dead[..., None], torch.zeros_like(merged.velocity), merged.velocity),
            angular_velocity=torch.where(dead, zero, merged.angular_velocity),
            throttle_accel=torch.where(dead, zero, merged.throttle_accel),
            brake_accel=torch.where(dead, zero, merged.brake_accel),
        )

        veh_veh, veh_edge = self._collisions(scenario, merged)
        return EnvState(
            bodies=merged,
            t=t_next,
            veh_veh_collision=veh_veh,
            veh_edge_collision=veh_edge,
            position_achieved=state.position_achieved,
            alive=alive_next,
        )
