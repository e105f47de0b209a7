"""Scenario data model: dense numpy struct-of-arrays, and its torch twin.

A copy of the JAX package's ``ctrl_sim_tpu/data/scenario.py``, cut to what
the benchmark's synthetic scenes reach: the ``Scenario`` dataclass (its
traffic-light fields stay, None, so that it maps field by field onto the
port's), ``_finalize`` (goal override, moving-object classification, road
chunking, road-edge packing) and ``stack_scenarios``. Scenes stay numpy
until ``to_torch`` moves every array field onto one device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from benchmark.reference.sim.config import Config

OBJECT_TYPES = {"unset": 0, "vehicle": 1, "pedestrian": 2, "cyclist": 3, "other": 4}
ROAD_TYPES = {
    "none": 0,
    "lane": 1,
    "road_line": 2,
    "road_edge": 3,
    "stop_sign": 4,
    "crosswalk": 5,
    "speed_bump": 6,
    "other": 7,
}

# Teleport sentinel for dead agents (policies/autoregressive_policy.py:263)
DEAD_POSITION = -1_000_000.0


@dataclass
class Scenario:
    """One scene as dense arrays. T+1 = steps + 1 recorded states (91).

    Stacked scenes carry a leading env axis on every array field; after
    ``to_torch`` the fields are tensors on one device.
    """

    # agents [A, ...]
    traj_position: np.ndarray  # [A, T1, 2]
    traj_heading: np.ndarray  # [A, T1] radians
    traj_speed: np.ndarray  # [A, T1]
    traj_valid: np.ndarray  # [A, T1] bool
    length: np.ndarray  # [A]
    width: np.ndarray  # [A]
    agent_type: np.ndarray  # [A] int (unset, vehicle, pedestrian, cyclist, other)
    agent_valid: np.ndarray  # [A] bool — slot holds a real agent
    goal_position: np.ndarray  # [A, 2]  (with last-valid-state override applied)
    goal_heading: np.ndarray  # [A]
    goal_speed: np.ndarray  # [A]
    goal_dist_normalizer: np.ndarray  # [A]
    moving: np.ndarray  # [A] bool — Nocturne getObjectsThatMoved membership
    # model polylines [P, ...]
    road_points: np.ndarray  # [P, L, 3] (x, y, valid)
    road_types: np.ndarray  # [P, 8] one-hot; padding rows are -1
    road_valid: np.ndarray  # [P] bool
    # road-edge polylines for signed distance [K, V, ...]
    edge_polylines: np.ndarray  # [K, V, 2]
    edge_poly_valid: np.ndarray  # [K, V] bool
    # road-edge segment soup for collision [S, ...]
    edge_seg_p0: np.ndarray  # [S, 2]
    edge_seg_p1: np.ndarray  # [S, 2]
    edge_seg_valid: np.ndarray  # [S] bool
    # optional recorded streams (physics JSON only)
    rewards: np.ndarray | None = None  # [A, T, 8]
    actions: np.ndarray | None = None  # [A, T, 2] (accel, steer)
    # traffic lights (scenario.cc:222-241; None when the JSON has no
    # ``tl_states``: the CtRL-Sim datasets are the no-TL Waymo exports)
    tl_position: np.ndarray | None = None  # [L, 2]
    tl_state: np.ndarray | None = None  # [L, T1] int8 (traffic_light.h:20-30)
    tl_valid: np.ndarray | None = None  # [L] bool
    name: str = ""


def _goal_override(
    traj_position: np.ndarray,
    traj_heading: np.ndarray,
    traj_speed: np.ndarray,
    traj_valid: np.ndarray,
    goal_position: np.ndarray,
    goal_heading: np.ndarray,
    goal_speed: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replace the goal by the last state before first disappearance when the
    agent does not survive the episode (evaluators/evaluator.py:60-76)."""
    A = traj_position.shape[0]
    for a in range(A):
        invalid = np.where(~traj_valid[a])[0]
        if len(invalid) > 0:
            idx_goal = invalid[0] - 1
            if (
                idx_goal >= 0
                and np.linalg.norm(traj_position[a, idx_goal] - goal_position[a]) > 0.0
            ):
                goal_position[a] = traj_position[a, idx_goal]
                goal_heading[a] = traj_heading[a, idx_goal]
                goal_speed[a] = traj_speed[a, idx_goal]
    return goal_position, goal_heading, goal_speed


def _chunk_roads(
    roads: Sequence[dict], cfg: Config
) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Chunk road geometries into fixed-size polylines and collect road-edge
    polylines, mirroring RLWaymoDataset.get_roads (dataset.py:73-108)."""
    L = cfg.waymo.max_num_road_pts_per_polyline
    final_roads: list[np.ndarray] = []
    final_types: list[np.ndarray] = []
    edge_polylines: list[np.ndarray] = []
    for road in roads:
        geometry = road["geometry"]
        rt = ROAD_TYPES.get(road["type"], 7)
        onehot = np.eye(8)[rt]
        if isinstance(geometry, dict):  # stop sign: degenerate polyline
            pt = np.array([geometry["x"], geometry["y"], 1.0])
            final_roads.append(np.repeat(pt[None, :], L, axis=0))
            final_types.append(onehot)
            continue
        if road["type"] == "road_edge":
            edge_polylines.append(
                np.array([[p["x"], p["y"]] for p in geometry], dtype=np.float64)
            )
        current: list[np.ndarray] = []
        for p in geometry:
            current.append(np.array([p["x"], p["y"], 1.0]))
            if len(current) == L:
                final_roads.append(np.array(current))
                final_types.append(onehot)
                current = []
        if 0 < len(current) < L:
            padded = np.zeros((L, 3))
            padded[: len(current)] = np.array(current)
            final_roads.append(padded)
            final_types.append(onehot)
    if final_roads:
        return np.array(final_roads), np.array(final_types), edge_polylines
    return np.zeros((0, L, 3)), np.zeros((0, 8)), edge_polylines


def _pack_edges(
    edge_polylines: list[np.ndarray], cfg: Config
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack road-edge polylines into padded polylines + segment soup."""
    max_segments = cfg.sim.max_road_edge_segments
    if edge_polylines:
        K = len(edge_polylines)
        V = max(max(len(p) for p in edge_polylines), 2)
    else:
        K, V = 1, 2
    polylines = np.zeros((K, V, 2))
    poly_valid = np.zeros((K, V), dtype=bool)
    segs0: list[np.ndarray] = []
    segs1: list[np.ndarray] = []
    for k, poly in enumerate(edge_polylines):
        n = len(poly)
        polylines[k, :n] = poly
        poly_valid[k, :n] = True
        if n >= 2:
            segs0.append(poly[:-1])
            segs1.append(poly[1:])
    if segs0:
        p0 = np.concatenate(segs0, axis=0)
        p1 = np.concatenate(segs1, axis=0)
    else:
        p0 = np.zeros((0, 2))
        p1 = np.zeros((0, 2))
    S = max_segments
    if len(p0) > S:
        raise ValueError(
            f"scene has {len(p0)} road-edge segments > max_road_edge_segments={S}; "
            "raise sim.max_road_edge_segments"
        )
    seg_p0 = np.zeros((S, 2))
    seg_p1 = np.zeros((S, 2))
    seg_valid = np.zeros(S, dtype=bool)
    seg_p0[: len(p0)] = p0
    seg_p1[: len(p1)] = p1
    seg_valid[: len(p0)] = True
    return polylines, poly_valid, seg_p0, seg_p1, seg_valid


def _finalize(
    cfg: Config,
    traj_position: np.ndarray,
    traj_heading: np.ndarray,
    traj_speed: np.ndarray,
    traj_valid: np.ndarray,
    length: np.ndarray,
    width: np.ndarray,
    agent_type: np.ndarray,
    goal_position: np.ndarray,
    goal_heading: np.ndarray,
    goal_speed: np.ndarray,
    roads: Sequence[dict],
    name: str,
    rewards: np.ndarray | None = None,
    actions: np.ndarray | None = None,
) -> Scenario:
    goal_position, goal_heading, goal_speed = _goal_override(
        traj_position, traj_heading, traj_speed, traj_valid,
        goal_position, goal_heading, goal_speed,
    )
    # moving-object classification (scenario.cc:940-951): at any valid step,
    # speed > speed_threshold or distance(pos, target) > moving_threshold.
    # NOTE: Nocturne tests against the raw target_position (pre-override).
    dist_to_goal = np.linalg.norm(traj_position - goal_position[:, None, :], axis=-1)
    moving = np.any(
        traj_valid
        & (
            (traj_speed > cfg.sim.speed_threshold)
            | (dist_to_goal > cfg.sim.moving_threshold)
        ),
        axis=1,
    )
    # goal-distance normalizer from the initial position (evaluator.py:79-84)
    goal_dist_normalizer = np.linalg.norm(traj_position[:, 0] - goal_position, axis=-1)

    road_points, road_types, edge_polylines = _chunk_roads(roads, cfg)
    polylines, poly_valid, seg_p0, seg_p1, seg_valid = _pack_edges(edge_polylines, cfg)

    A = traj_position.shape[0]
    return Scenario(
        traj_position=traj_position.astype(np.float32),
        traj_heading=traj_heading.astype(np.float32),
        traj_speed=traj_speed.astype(np.float32),
        traj_valid=traj_valid,
        length=length.astype(np.float32),
        width=width.astype(np.float32),
        agent_type=agent_type.astype(np.int32),
        agent_valid=np.ones(A, dtype=bool),
        goal_position=goal_position.astype(np.float32),
        goal_heading=goal_heading.astype(np.float32),
        goal_speed=goal_speed.astype(np.float32),
        goal_dist_normalizer=goal_dist_normalizer.astype(np.float32),
        moving=moving,
        road_points=road_points.astype(np.float32),
        road_types=road_types.astype(np.float32),
        road_valid=np.ones(len(road_points), dtype=bool),
        edge_polylines=polylines.astype(np.float32),
        edge_poly_valid=poly_valid,
        edge_seg_p0=seg_p0.astype(np.float32),
        edge_seg_p1=seg_p1.astype(np.float32),
        edge_seg_valid=seg_valid,
        rewards=None if rewards is None else rewards.astype(np.float32),
        actions=None if actions is None else actions.astype(np.float32),
        name=name,
    )


def pad_scenarios(scenarios: list[Scenario], cfg: Config) -> list[Scenario]:
    """Pad every scenario to common static shapes (agents, polylines, edge
    polylines) so they can be stacked into one batch."""
    A = max(cfg.sim.max_agents, max(s.traj_position.shape[0] for s in scenarios))
    P = max(
        cfg.waymo.max_num_road_polylines,
        max(s.road_points.shape[0] for s in scenarios),
    )
    K = max(s.edge_polylines.shape[0] for s in scenarios)
    V = max(s.edge_polylines.shape[1] for s in scenarios)
    T1 = max(s.traj_position.shape[1] for s in scenarios)
    tl_L = max((s.tl_position.shape[0] for s in scenarios if s.tl_position is not None), default=0)
    return [_pad_one(s, A, P, K, V, T1, tl_L) for s in scenarios]


def _pad_to(arr: np.ndarray, shape: tuple[int, ...], fill: float = 0.0) -> np.ndarray:
    pads = [(0, t - c) for t, c in zip(shape, arr.shape)]
    return np.pad(arr, pads, constant_values=fill)


def _pad_one(
    s: Scenario, A: int, P: int, K: int, V: int, T1: int, tl_L: int = 0
) -> Scenario:
    road_types = _pad_to(s.road_types, (P, 8), fill=-1.0)
    # traffic lights: scenes without lights get all-invalid pad rows when the
    # batch holds any lights (so the light fields stack to one shape)
    tl_fields = dict(tl_position=None, tl_state=None, tl_valid=None)
    if tl_L > 0:
        tl_pos = s.tl_position if s.tl_position is not None else np.zeros((0, 2), np.float32)
        tl_st = s.tl_state if s.tl_state is not None else np.zeros((0, T1), np.int8)
        tl_va = s.tl_valid if s.tl_valid is not None else np.zeros((0,), bool)
        tl_fields = dict(
            tl_position=_pad_to(tl_pos, (tl_L, 2)).astype(np.float32),
            tl_state=_pad_to(tl_st, (tl_L, T1)).astype(np.int8),
            tl_valid=_pad_to(tl_va, (tl_L,)).astype(bool),
        )
    return dataclasses.replace(
        s,
        traj_position=_pad_to(s.traj_position, (A, T1, 2), DEAD_POSITION),
        traj_heading=_pad_to(s.traj_heading, (A, T1)),
        traj_speed=_pad_to(s.traj_speed, (A, T1)),
        traj_valid=_pad_to(s.traj_valid, (A, T1)).astype(bool),
        length=_pad_to(s.length, (A,), 1.0),
        width=_pad_to(s.width, (A,), 1.0),
        agent_type=_pad_to(s.agent_type, (A,)).astype(np.int32),
        agent_valid=_pad_to(s.agent_valid, (A,)).astype(bool),
        goal_position=_pad_to(s.goal_position, (A, 2)),
        goal_heading=_pad_to(s.goal_heading, (A,)),
        goal_speed=_pad_to(s.goal_speed, (A,)),
        goal_dist_normalizer=_pad_to(s.goal_dist_normalizer, (A,)),
        moving=_pad_to(s.moving, (A,)).astype(bool),
        road_points=_pad_to(s.road_points, (P, s.road_points.shape[1], 3)),
        road_types=road_types,
        road_valid=_pad_to(s.road_valid, (P,)).astype(bool),
        edge_polylines=_pad_to(s.edge_polylines, (K, V, 2)),
        edge_poly_valid=_pad_to(s.edge_poly_valid, (K, V)).astype(bool),
        rewards=None if s.rewards is None else _pad_to(s.rewards, (A,) + s.rewards.shape[1:]),
        actions=None if s.actions is None else _pad_to(s.actions, (A,) + s.actions.shape[1:]),
        **tl_fields,
    )


def stack_scenarios(scenarios: list[Scenario], cfg: Config) -> Scenario:
    """Pad + stack scenarios into one Scenario with a leading env axis; an
    optional field is None unless every scene holds it."""
    padded = pad_scenarios(scenarios, cfg)
    fields = [f.name for f in dataclasses.fields(Scenario) if f.name != "name"]
    batch = {}
    for f in fields:
        values = [getattr(s, f) for s in padded]
        batch[f] = None if any(v is None for v in values) else np.stack(values, axis=0)
    batch["name"] = tuple(s.name for s in padded)
    return Scenario(**batch)


def to_torch(scenario: Scenario, device: torch.device | str) -> Scenario:
    """Copy every array field of a (stacked) scenario onto ``device``:
    floats as float32, integers as int64, booleans as bool; an absent
    optional field stays None."""
    out = {}
    for f in dataclasses.fields(Scenario):
        v = getattr(scenario, f.name)
        if isinstance(v, np.ndarray):
            if v.dtype == np.bool_:
                v = torch.as_tensor(v, device=device)
            elif np.issubdtype(v.dtype, np.integer):
                v = torch.as_tensor(v.astype(np.int64), device=device)
            else:
                v = torch.as_tensor(v.astype(np.float32), device=device)
        out[f.name] = v
    return Scenario(**out)
