"""Synthetic scenario generator (a copy of ``ctrl_sim_tpu/data/synthetic.py``).

Produces self-consistent scenes in the same Scenario array format as the
Waymo converter: a rectangular drivable boundary (counterclockwise road-edge
polyline, so signed distance is negative inside), lane centerlines, and
vehicles whose ground-truth trajectories are generated by the kinematic
bicycle model under smooth random controls — which makes inverse-bicycle
replay (the offline-RL data-generation rule,
data/generate_offline_rl_dataset.py:88-119) well-posed.

Used by the tests and by ``chip_smoke.py``; the JSON loaders of real
Waymo scenes are not ported yet.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.sim.config import Config
from benchmark.reference.sim.data.scenario import Scenario, _finalize


def synthetic_scenario(
    cfg: Config,
    seed: int = 0,
    num_agents: int = 8,
    arena_half: float = 200.0,
    num_lanes: int = 4,
    invalid_tail_agents: int = 1,
    conflict_pairs: int = 0,
) -> Scenario:
    """Generate one synthetic scene.

    Args:
      cfg: framework config (steps, dt, road chunking sizes).
      seed: numpy seed; scenes are deterministic in it.
      num_agents: number of vehicles.
      arena_half: half-extent of the square drivable area.
      num_lanes: number of lane centerlines to emit as map features.
      invalid_tail_agents: this many agents disappear partway through the
        episode (exercises existence-mask handling).
      conflict_pairs: this many agent pairs are re-spawned on crossing
        courses timed to meet mid-episode with a randomized lateral aim
        offset, so their GT trajectories collide, graze, or narrowly miss.
        A corpus with conflicts populates the low/medium veh-veh
        return-to-go bins of the offline-RL dataset — the support that
        exponential tilting (policies/policy.py:108-142) re-weights; a
        conflict-free corpus trains an RTG head whose veh-veh marginal is a
        near-delta at "no collision", leaving negative tilts nothing to
        amplify (observed round 5: tilt +-10 had zero behavioral effect on
        a conflict-free-trained model).
    """
    rng = np.random.default_rng(seed)
    T1 = cfg.sim.steps + 1
    dt = cfg.sim.dt

    # --- agents: kinematic bicycle rollouts with smooth random controls ----
    A = num_agents
    length = rng.uniform(3.8, 5.2, size=A)
    width = rng.uniform(1.7, 2.2, size=A)
    # spawn on a grid with headings roughly axis-aligned
    pos0 = rng.uniform(-arena_half * 0.6, arena_half * 0.6, size=(A, 2))
    heading0 = rng.uniform(-np.pi, np.pi, size=A)
    speed0 = rng.uniform(0.0, 15.0, size=A)

    # smooth controls: OU-like noise, small steering
    accel = np.zeros((A, T1))
    steer = np.zeros((A, T1))
    a_state = rng.normal(0.0, 1.0, size=A)
    s_state = rng.normal(0.0, 0.05, size=A)
    for t in range(T1):
        a_state += 0.3 * (-a_state) + rng.normal(0.0, 0.4, size=A)
        s_state += 0.3 * (-s_state) + rng.normal(0.0, 0.02, size=A)
        accel[:, t] = np.clip(a_state, -4.0, 4.0)
        steer[:, t] = np.clip(s_state, -0.3, 0.3)

    # --- conflict pairs: crossing courses timed to meet ------------------
    # Agents 1, 2, ... (agent 0 stays the parked car; the invalid-tail
    # agents at the end keep their role) are re-spawned in pairs aimed at a
    # shared crossing point reached at the same time. The second agent of
    # each pair aims at a laterally offset point (sigma 2 m), so outcomes
    # range from square hits through glancing contact to near misses —
    # exactly the return-to-go diversity the RTG head needs.
    n_free = A - 1 - min(invalid_tail_agents, A)
    for k in range(min(conflict_pairs, n_free // 2)):
        i, j = 1 + 2 * k, 2 + 2 * k
        c = rng.uniform(-0.3 * arena_half, 0.3 * arena_half, size=2)
        ang_i = rng.uniform(-np.pi, np.pi)
        ang_j = ang_i + rng.choice([-1.0, 1.0]) * rng.uniform(
            np.pi / 3, 2 * np.pi / 3
        )
        v_i, v_j = rng.uniform(6.0, 14.0, size=2)
        t_meet = rng.uniform(0.35, 0.65) * T1 * dt
        d_i = np.array([np.cos(ang_i), np.sin(ang_i)])
        d_j = np.array([np.cos(ang_j), np.sin(ang_j)])
        # j aims at c plus a lateral offset across i's path, and arrives
        # with a jittered time offset — together these spread outcomes over
        # square hits, glancing contact, and near misses
        perp = np.array([-d_i[1], d_i[0]])
        aim_j = c + perp * rng.normal(0.0, 3.0)
        t_meet_j = t_meet + rng.normal(0.0, 0.7)
        pos0[i] = c - d_i * v_i * t_meet
        pos0[j] = aim_j - d_j * v_j * max(t_meet_j, 0.5)
        heading0[i], heading0[j] = ang_i, ang_j
        speed0[i], speed0[j] = v_i, v_j
        # hold course: no steering, mild speed noise
        steer[i] = steer[j] = 0.0
        accel[i] = np.clip(accel[i] * 0.2, -0.8, 0.8)
        accel[j] = np.clip(accel[j] * 0.2, -0.8, 0.8)

    traj_position = np.zeros((A, T1, 2))
    traj_heading = np.zeros((A, T1))
    traj_speed = np.zeros((A, T1))
    pos, heading, speed = pos0.copy(), heading0.copy(), speed0.copy()
    for t in range(T1):
        traj_position[:, t] = pos
        traj_heading[:, t] = heading
        traj_speed[:, t] = speed
        # kinematic bicycle step (object.cc:126-137), numpy mirror
        v = speed + 0.5 * accel[:, t] * dt
        tan_delta = np.tan(steer[:, t])
        beta = np.arctan(0.5 * tan_delta)
        direction = heading + beta
        pos = pos + (v * dt)[:, None] * np.stack(
            [np.cos(direction), np.sin(direction)], axis=-1
        )
        w = v * np.cos(beta) * tan_delta / length
        heading = np.mod(heading + w * dt + np.pi, 2 * np.pi) - np.pi
        speed = speed + accel[:, t] * dt
        speed = np.maximum(speed, 0.0)  # keep forward motion for realism

    traj_valid = np.ones((A, T1), dtype=bool)
    for i in range(min(invalid_tail_agents, A)):
        cut = int(rng.integers(T1 // 3, 2 * T1 // 3))
        traj_valid[A - 1 - i, cut:] = False

    # a couple of parked cars: overwrite with stationary trajectories
    if A >= 3:
        for a in (0,):
            traj_position[a] = traj_position[a, 0]
            traj_heading[a] = traj_heading[a, 0]
            traj_speed[a] = 0.0

    goal_position = np.zeros((A, 2))
    goal_heading = np.zeros(A)
    goal_speed = np.zeros(A)
    for a in range(A):
        last = np.where(traj_valid[a])[0][-1]
        goal_position[a] = traj_position[a, last]
        goal_heading[a] = traj_heading[a, last]
        goal_speed[a] = traj_speed[a, last]

    agent_type = np.full(A, 1, dtype=np.int64)  # all vehicles

    # --- roads -------------------------------------------------------------
    roads: list[dict] = []
    h = arena_half

    def _poly(points: np.ndarray) -> list[dict]:
        return [{"x": float(x), "y": float(y)} for x, y in points]

    # CCW rectangular boundary (drivable inside => negative signed distance)
    n_side = 40
    xs = np.linspace(-h, h, n_side)
    boundary = np.concatenate(
        [
            np.stack([xs, np.full(n_side, -h)], axis=-1),
            np.stack([np.full(n_side, h), xs], axis=-1),
            np.stack([xs[::-1], np.full(n_side, h)], axis=-1),
            np.stack([np.full(n_side, -h), xs[::-1]], axis=-1),
        ],
        axis=0,
    )
    roads.append({"geometry": _poly(boundary), "type": "road_edge"})

    # lane centerlines
    for i in range(num_lanes):
        y = -h * 0.5 + i * h / max(num_lanes - 1, 1)
        lane = np.stack([np.linspace(-h, h, 60), np.full(60, y)], axis=-1)
        roads.append({"geometry": _poly(lane), "type": "lane"})
    # one stop sign
    roads.append({"geometry": {"x": 0.0, "y": 0.0}, "type": "stop_sign"})

    return _finalize(
        cfg,
        traj_position,
        traj_heading,
        traj_speed,
        traj_valid,
        length,
        width,
        agent_type,
        goal_position,
        goal_heading,
        goal_speed,
        roads,
        name=f"synthetic_{seed}",
    )
