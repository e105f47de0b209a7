"""CAT adversarial-trajectory utilities (port of ``ctrl_sim_tpu/evals/cat.py``).

The polyline helpers (utils/sim.py:198-222) used when replaying
CAT/DenseTNT adversarial trajectories through physics
(data/generate_offline_rl_cat_dataset.py, planner_adversary_evaluator.py),
plus the finetuning-scenario builder: given a base scene and an adversarial
trajectory for a focal agent, produce a Scenario whose GT rows carry the
attack — the input format of the adversarial finetuning dataset.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ctrl_sim_tpu_torch.data.scenario import Scenario


def moving_average(data: np.ndarray, window_size: int) -> np.ndarray:
    """utils/sim.py:198-202."""
    interval = np.pad(data, window_size // 2, "edge")
    window = np.ones(int(window_size)) / float(window_size)
    return np.convolve(interval, window, "valid")


def polyline_yaw(polyline: np.ndarray) -> np.ndarray:
    """Heading along a polyline with unwrapping + 5-point smoothing
    (utils/sim.py:204-215)."""
    post = np.roll(polyline, shift=-1, axis=0)
    diff = post - polyline
    yaw = np.arctan2(diff[:, 1], diff[:, 0])
    yaw[-1] = yaw[-2]
    for i in range(len(yaw) - 1):
        if yaw[i + 1] - yaw[i] > 1.5 * np.pi:
            yaw[i + 1] -= 2 * np.pi
        elif yaw[i] - yaw[i + 1] > 1.5 * np.pi:
            yaw[i + 1] += 2 * np.pi
    return moving_average(yaw, window_size=5)


def polyline_vel(polyline: np.ndarray, dt: float = 0.1) -> np.ndarray:
    """Finite-difference velocities (utils/sim.py:217-222)."""
    post = np.roll(polyline, shift=-1, axis=0)
    post[-1] = polyline[-1]
    return (post - polyline) / dt


def make_adversarial_scenario(
    scene: Scenario, focal_agent_idx: int, adv_positions: np.ndarray
) -> tuple[Scenario, int]:
    """Build a finetuning scenario: the focal agent's GT trajectory replaced
    by the CAT attack (generate_offline_rl_cat_dataset.py replays exactly
    this through physics). Returns (scenario, focal_agent_idx)."""
    T1 = scene.traj_position.shape[1]
    adv = np.asarray(adv_positions)[:T1]
    yaw = polyline_yaw(adv)
    speed = np.linalg.norm(polyline_vel(adv), axis=-1)
    n = len(adv)
    tp = scene.traj_position.copy()
    th = scene.traj_heading.copy()
    ts = scene.traj_speed.copy()
    tv = scene.traj_valid.copy()
    tp[focal_agent_idx, :n] = adv
    th[focal_agent_idx, :n] = yaw
    ts[focal_agent_idx, :n] = speed
    tv[focal_agent_idx, :n] = True
    tv[focal_agent_idx, n:] = False
    out = dataclasses.replace(
        scene,
        traj_position=tp,
        traj_heading=th,
        traj_speed=ts,
        traj_valid=tv,
        name=scene.name + "_cat",
    )
    return out, focal_agent_idx


def match_adversary_by_position(
    scene: Scenario,
    sdc_pos: np.ndarray,  # [2] CAT ego (SDC) initial position
    adv_pos: np.ndarray,  # [2] CAT adversary initial position
    candidates: np.ndarray | None = None,  # agent indices; default: all valid
    tol: float = 0.01,
) -> tuple[int | None, int | None, bool]:
    """Match a CAT/MD scenario's (sdc, adversary) to scene agent indices by
    initial-position proximity (filter_valid_cat_scenarios.py:21-49's
    match_md_to_nocturne, minus that script's shipped-broken debug exit):
    the nearer candidate to the CAT sdc becomes the ego, the other the
    adversary, and the match only stands if both line up within ``tol``.

    Returns (sdc_idx, adversary_idx, matched).
    """
    sdc_pos = np.asarray(sdc_pos, np.float64)
    adv_pos = np.asarray(adv_pos, np.float64)
    # the reference treats a zero-x position as "no pair recorded"
    if sdc_pos[0] == 0 or adv_pos[0] == 0:
        return None, None, False
    if candidates is None:
        candidates = np.where(np.asarray(scene.traj_valid)[:, 0])[0]
    candidates = np.asarray(candidates)
    if len(candidates) < 2:
        return None, None, False

    pos0 = np.asarray(scene.traj_position)[candidates, 0]  # [C, 2]
    d_sdc = np.linalg.norm(pos0 - sdc_pos, axis=-1)
    sdc_i = int(candidates[np.argmin(d_sdc)])
    d_adv = np.linalg.norm(pos0 - adv_pos, axis=-1)
    d_adv[candidates == sdc_i] = np.inf
    adv_i = int(candidates[np.argmin(d_adv)])

    matched = (
        np.linalg.norm(np.asarray(scene.traj_position)[sdc_i, 0] - sdc_pos) < tol
        and np.linalg.norm(np.asarray(scene.traj_position)[adv_i, 0] - adv_pos) < tol
    )
    return sdc_i, adv_i, bool(matched)
