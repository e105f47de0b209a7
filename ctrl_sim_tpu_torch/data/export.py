"""Dataset interop + split tooling (port of ``ctrl_sim_tpu/data/export.py``;
host-side numpy and the standard library).

- ``export_physics_json``: write a replayed scenario back out in the
  reference's offline-RL ``*_physics.json`` dialect
  (data/generate_offline_rl_dataset.py:135-142) so datasets generated here
  are readable by the reference stack and vice versa.
- ``export_raw_json``: write one scene in the raw Nocturne Waymo dialect
  (``formatted_json_v2_no_tl_*``: headings in degrees, ``valid`` flags,
  ``goalPosition``), which ``data/scenario.py:load_scenario_json`` reads
  back to the same scene; no counterpart in the JAX package.
- ``split_val_test``: the seeded val/test split (data/split_val_test.py):
  shuffle with seed 2024, take 2500 test scenes, emit the filename lists.
- ``filter_valid_cat``: drop CAT scenarios whose adversary trajectory never
  comes near the ego (data/filter_valid_cat_scenarios.py's validity idea:
  keep attacks that actually create interaction).
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data.datagen import OfflineArrays
from ctrl_sim_tpu_torch.data.scenario import OBJECT_TYPES, ROAD_TYPES, Scenario
from ctrl_sim_tpu_torch.device import host

_TYPE_NAMES = {v: k for k, v in OBJECT_TYPES.items()}
_ROAD_NAMES = {v: k for k, v in ROAD_TYPES.items()}


def export_physics_json(
    cfg: Config,
    scenario: Scenario,
    offline: OfflineArrays,
    env_index: int,
    path: str,
) -> None:
    """Write one scene's replay streams as a *_physics.json. ``scenario``
    and ``offline`` hold numpy arrays or tensors on any device."""
    states = host(offline.states[env_index])  # [A, T, 8]
    actions = host(offline.actions[env_index])
    rewards = host(offline.rewards8[env_index])
    sc = {k: host(getattr(scenario, k)[env_index]) for k in (
        "agent_valid", "goal_position", "goal_heading", "goal_speed", "width", "length", "agent_type",
        "road_points", "road_types", "road_valid")}
    A, T, _ = states.shape

    objects = []
    for a in range(A):
        if not bool(sc["agent_valid"][a]):
            continue
        objects.append(
            {
                "position": [
                    {"x": float(x), "y": float(y)} for x, y in states[a, :, :2]
                ],
                "velocity": [
                    {"x": float(x), "y": float(y)} for x, y in states[a, :, 2:4]
                ],
                "heading": [float(h) for h in states[a, :, 4]],
                "existence": [float(e) for e in states[a, :, 7]],
                "acceleration": [float(v) for v in actions[a, :, 0]],
                "steering": [float(v) for v in actions[a, :, 1]],
                "reward": [[float(x) for x in row] for row in rewards[a]],
                "goal_position": {
                    "x": float(sc["goal_position"][a, 0]),
                    "y": float(sc["goal_position"][a, 1]),
                },
                "goal_heading": float(sc["goal_heading"][a]),
                "goal_speed": float(sc["goal_speed"][a]),
                "width": float(sc["width"][a]),
                "length": float(sc["length"][a]),
                "type": _TYPE_NAMES.get(
                    int(sc["agent_type"][a]), "vehicle"
                ),
            }
        )

    roads = []
    rp = sc["road_points"]
    rt = sc["road_types"]
    rv = sc["road_valid"]
    for p in range(rp.shape[0]):
        if not rv[p]:
            continue
        kind = _ROAD_NAMES.get(int(np.argmax(rt[p])), "other")
        pts = rp[p][rp[p][:, 2] > 0]
        if kind == "stop_sign" and len(pts) > 0:
            roads.append(
                {"geometry": {"x": float(pts[0, 0]), "y": float(pts[0, 1])},
                 "type": kind}
            )
        elif len(pts) > 0:
            roads.append(
                {
                    "geometry": [
                        {"x": float(x), "y": float(y)} for x, y, _ in pts
                    ],
                    "type": kind,
                }
            )

    data = {"name": os.path.basename(path), "objects": objects, "roads": roads}
    with open(path, "w") as f:
        json.dump(data, f)


def export_raw_json(scene: Scenario, path: str, tl_states: list | None = None) -> None:
    """Write one (unstacked, numpy) scene as a raw-dialect JSON: its valid
    agents as vehicles (heading in degrees, velocity from speed and
    heading), its road edges as whole polylines, every other road polyline
    as one road (a stop sign as a point), and ``tl_states`` if given."""
    objects = []
    for a in np.flatnonzero(scene.agent_valid):
        heading = scene.traj_heading[a].astype(np.float64)
        speed = scene.traj_speed[a].astype(np.float64)
        objects.append({
            "type": _TYPE_NAMES.get(int(scene.agent_type[a]), "vehicle"),
            "position": [{"x": float(x), "y": float(y)} for x, y in scene.traj_position[a]],
            "velocity": [{"x": float(v * np.cos(h)), "y": float(v * np.sin(h))} for v, h in zip(speed, heading)],
            "heading": [float(h) for h in np.rad2deg(heading)],
            "valid": [bool(v) for v in scene.traj_valid[a]],
            "length": float(scene.length[a]),
            "width": float(scene.width[a]),
            "goalPosition": {"x": float(scene.goal_position[a, 0]), "y": float(scene.goal_position[a, 1])},
        })
    roads = []
    for poly, valid in zip(scene.edge_polylines, scene.edge_poly_valid):
        if valid.any():
            roads.append({"type": "road_edge", "geometry": [{"x": float(x), "y": float(y)} for x, y in poly[valid]]})
    for pts, onehot, valid in zip(scene.road_points, scene.road_types, scene.road_valid):
        kind = _ROAD_NAMES.get(int(np.argmax(onehot)), "other")
        pts = pts[pts[:, 2] > 0]
        if not valid or kind == "road_edge" or len(pts) == 0:
            continue
        if kind == "stop_sign":
            roads.append({"type": kind, "geometry": {"x": float(pts[0, 0]), "y": float(pts[0, 1])}})
        else:
            roads.append({"type": kind, "geometry": [{"x": float(x), "y": float(y)} for x, y, _ in pts]})
    data = {"name": os.path.basename(path), "objects": objects, "roads": roads}
    if tl_states:
        data["tl_states"] = tl_states
    with open(path, "w") as f:
        json.dump(data, f)


def split_val_test(
    filenames: list[str],
    seed: int = 2024,
    num_test: int = 2500,
) -> tuple[list[str], list[str]]:
    """Seeded shuffle -> (val, test) filename lists (split_val_test.py:28-45)."""
    files = sorted(filenames)
    rng = random.Random(seed)
    rng.shuffle(files)
    test = files[:num_test]
    val = files[num_test:]
    return val, test


def write_test_filenames(test: list[str], path: str) -> None:
    """Emit test_filenames.json (the reference pickles; JSON travels better)."""
    with open(path, "w") as f:
        json.dump({"test_filenames": [os.path.basename(t) for t in test]}, f)


def filter_valid_cat(
    scenes: list[Scenario],
    ego_indices: list[int],
    adversary_indices: list[int],
    min_approach_dist: float = 10.0,
) -> list[int]:
    """Indices of CAT scenes whose adversary actually approaches the ego
    within ``min_approach_dist`` at some step — invalid attacks never
    interact and are dropped (filter_valid_cat_scenarios.py)."""
    keep = []
    for i, scene in enumerate(scenes):
        ego, adv = ego_indices[i], adversary_indices[i]
        pe = scene.traj_position[ego]
        pa = scene.traj_position[adv]
        valid = scene.traj_valid[ego] & scene.traj_valid[adv]
        if not valid.any():
            continue
        d = np.linalg.norm(pe - pa, axis=-1)[valid]
        if d.min() < min_approach_dist:
            keep.append(i)
    return keep
