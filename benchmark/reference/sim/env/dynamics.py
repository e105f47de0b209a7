"""Vehicle dynamics on batched tensors (port of ``ctrl_sim_tpu/env/dynamics.py``).

``kinematic_bicycle_step`` replicates Object::KinematicBicycleStep
(nocturne/cpp/src/object.cc:126-137); ``freecar_step`` the Box2D FreeCar
velocity-level model (FreeCar.cpp:98-181 + the b2World integration) that the
reference's eval and data-generation paths run; ``inverse_bicycle_action``
is BicycleModel.backward (nocturne/bicycle_model.py:51-109). All functions
are elementwise over any leading [env, agent] axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.sim.config import PhysicsConfig
from benchmark.reference.sim.geometry import angle_add, angle_sub

Tensor = torch.Tensor


class BodyState(NamedTuple):
    """Rigid-body state carried between steps. ``throttle_accel`` and
    ``brake_accel`` are FreeCar's persistent command state: FreeCar::Brake
    ignores |value| < 0.001 (FreeCar.cpp:77-82), and the previous commands
    then stay in force."""

    position: Tensor  # [..., 2]
    heading: Tensor  # [...]
    speed: Tensor  # [...]
    velocity: Tensor  # [..., 2]
    angular_velocity: Tensor  # [...]
    throttle_accel: Tensor  # [...]
    brake_accel: Tensor  # [...]


def _unit(angle: Tensor) -> Tensor:
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def kinematic_bicycle_step(
    position: Tensor,
    heading: Tensor,
    speed: Tensor,
    acceleration: Tensor,
    steering: Tensor,
    length: Tensor,
    dt: float,
) -> tuple[Tensor, Tensor, Tensor]:
    """One kinematic bicycle step (reference: object.cc:126-137)."""
    v = speed + 0.5 * acceleration * dt
    tan_delta = torch.tan(steering)
    beta = torch.atan(0.5 * tan_delta)
    new_position = position + v[..., None] * dt * _unit(heading + beta)
    w = v * torch.cos(beta) * tan_delta / length
    return new_position, angle_add(heading, w * dt), speed + acceleration * dt


def _dampen_speed(speed: Tensor, target: Tensor | float, damping: float, dt: float) -> Tensor:
    """Move ``speed`` toward ``target`` by at most damping*dt
    (reference: FreeCar.cpp:91-99 DampenSpeed)."""
    reduction = damping * dt
    return torch.where(
        speed - target > reduction,
        speed - reduction,
        torch.where(speed - target < -reduction, speed + reduction, target),
    )


def freecar_step(
    state: BodyState,
    acceleration: Tensor,
    steering: Tensor,
    length: Tensor,
    dt: float,
    cfg: PhysicsConfig = PhysicsConfig(),
) -> BodyState:
    """One FreeCar physics step (reference: FreeCar.cpp:98-181, then the
    gravity-free b2World velocity integration). ``acceleration > 0`` is
    Throttle(a); otherwise Brake(|a|), ignored below the deadband."""
    zero = torch.zeros_like(acceleration)
    is_throttle = acceleration > 0.0
    is_brake = (~is_throttle) & (acceleration.abs() >= cfg.brake_deadband)
    throttle_accel = torch.where(
        is_throttle,
        cfg.max_throttle_accel * acceleration,
        torch.where(is_brake, zero, state.throttle_accel),
    )
    brake_accel = torch.where(
        is_throttle,
        zero,
        torch.where(is_brake, cfg.max_brake_accel * -acceleration, state.brake_accel),
    )

    # accel/target resolution (FreeCar.cpp:101-137)
    accelerating_fwd = throttle_accel > brake_accel
    speed_target_pos = torch.where(accelerating_fwd, cfg.max_speed, 0.0)
    accel_pos = torch.where(
        accelerating_fwd, throttle_accel - brake_accel, brake_accel - throttle_accel
    )
    accelerating_rev = throttle_accel < -brake_accel
    speed_target_neg = torch.where(accelerating_rev, cfg.max_reverse_speed, 0.0)
    accel_neg = torch.where(
        accelerating_rev, -throttle_accel - brake_accel, brake_accel + throttle_accel
    )
    throttle_positive = throttle_accel > 0.0
    speed_target = torch.where(throttle_positive, speed_target_pos, speed_target_neg)
    accel_mag = torch.where(throttle_positive, accel_pos, accel_neg)

    beta = torch.atan(0.5 * torch.tan(steering))
    direction = state.heading + beta
    forward = _unit(direction)
    right = torch.stack([torch.sin(direction), -torch.cos(direction)], dim=-1)

    speed_forward = (state.velocity * forward).sum(-1)
    speed_right = (state.velocity * right).sum(-1)

    delta_v = accel_mag * dt
    speed_forward = torch.where(
        speed_forward < speed_target,
        torch.minimum(speed_forward + delta_v, speed_target),
        torch.maximum(speed_forward - delta_v, speed_target),
    )

    # steering -> target angular speed; min turn radius = vehicle length
    # (FreeCar.cpp:167-173)
    steering_angular_speed = torch.where(
        steering.abs() > 1e-7,
        speed_forward * torch.tan(steering) * torch.cos(beta) / length,
        zero,
    )

    speed_right = _dampen_speed(speed_right, 0.0, cfg.side_speed_damping, dt)
    angular_velocity = _dampen_speed(
        state.angular_velocity, steering_angular_speed, cfg.angular_damping, dt
    )

    velocity = right * speed_right[..., None] + forward * speed_forward[..., None]
    position = state.position + velocity * dt
    heading = angle_add(state.heading, angular_velocity * dt)
    speed = torch.sqrt((velocity * velocity).sum(-1).clamp(min=0.0))
    return BodyState(
        position=position,
        heading=heading,
        speed=speed,
        velocity=velocity,
        angular_velocity=angular_velocity,
        throttle_accel=throttle_accel,
        brake_accel=brake_accel,
    )


def body_state_from_pose(position: Tensor, heading: Tensor, speed: Tensor) -> BodyState:
    """A physics body from (pos, heading, speed), as
    Vehicle::CreatePhysicsBody does (vehicle.cc:139-176)."""
    zeros = torch.zeros_like(heading)
    return BodyState(
        position=position,
        heading=heading,
        speed=speed,
        velocity=speed[..., None] * _unit(heading),
        angular_velocity=zeros,
        throttle_accel=zeros,
        brake_accel=zeros,
    )


def inverse_bicycle_action(
    next_position: Tensor,
    next_heading: Tensor,
    next_speed: Tensor,
    prev_position: Tensor,
    prev_heading: Tensor,
    prev_speed: Tensor,
    length: Tensor,
    dt: float,
    max_steer: float = 0.7,
) -> tuple[Tensor, Tensor]:
    """Recover (accel, steer) that move prev -> next states
    (reference: BicycleModel.backward with prev_theta and prev_vel given,
    as all call sites do; the positions then do not enter the result).

    accel = (v_next - v_prev) / dt
    w     = angle_sub(theta_prev, theta_next) / dt
    C     = 2 L w / (v_next + v_prev + 1e-10)
    steer = clip(atan(2C / sqrt(4 - C^2)), -max_steer, max_steer), NaN -> 0
    """
    del next_position, prev_position
    accel = (next_speed - prev_speed) / dt
    w = angle_sub(prev_heading, next_heading) / dt
    c = 2.0 * length * w / (next_speed + prev_speed + 1e-10)
    denom_sq = 4.0 - c * c
    safe = denom_sq > 0.0
    steer = torch.where(
        safe,
        torch.atan(2.0 * c / torch.sqrt(torch.where(safe, denom_sq, torch.ones_like(denom_sq)))),
        torch.zeros_like(c),
    )
    return accel, steer.clamp(-max_steer, max_steer)
