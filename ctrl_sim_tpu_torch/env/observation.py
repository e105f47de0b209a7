"""Ego-centric observation: the Nocturne visible-state API (port of
``ctrl_sim_tpu/env/observation.py``).

- ``visible_objects_mask``: circular-sector visibility with sight-blocking
  occluders (nocturne view_field.cc FilterVisibleObjects / scenario.cc:333-389
  VisibleObjects): an object is visible when a corner lies in the ego's view
  cone (radius + half-angle around its heading) and the sight segment to
  some such corner crosses no other existing object's bounding box.
- ``ego_state``: [speed, dist_to_goal, rel_goal_heading, length, width]
  (scenario.cc:391-416 EgoState).
- ``flattened_visible_state``: nearest-K visible-object features in the ego
  frame (scenario.cc:418-548): [valid, dist, azimuth, length, width,
  rel_heading, rel_velocity_heading, rel_speed, object-type one-hot].
- ``road_point_features``: nearest-K visible road points, road edges first
  (scenario.cc:106-143 NearestKRoadPoints, :165-182
  ExtractRoadPointFeature; cone view_field.cc:196-202, occlusion
  scenario.cc:49-76).
- ``stop_sign_features``: nearest-K stop signs (degenerate kStopSign
  polylines), cone-filtered (scenario.cc:196-203, view_field.cc:172-180).

Every function takes a leading scene axis [E, ...] where the JAX function
is vmapped over scenes. The orders are the JAX package's: stable sorts on
the same float32 keys (``road_edge_first`` sorts on one key, the distance
plus 2 * view_dist + 1e4 for a point that is not a road edge, so points
that tie on it keep their index order), norms as sqrt(sum(x * x)), and
the corner form of the segment test (``geometry.obb_segment_intersects``).
"""

from __future__ import annotations

import math

import torch

from ctrl_sim_tpu_torch.geometry import angle_sub, normalize_angle, obb_corners, obb_segment_intersects

Tensor = torch.Tensor

ROAD_EDGE_TYPE = 3  # RoadType::kRoadEdge (nocturne road.h:21-30)
STOP_SIGN_TYPE = 4  # RoadType::kStopSign
VIEW_ANGLE = math.pi * (120.0 / 180.0)
BLOCKER_CHUNK = 8  # blockers per occlusion pass of road_point_features (bounds its memory)


def _norm(x: Tensor) -> Tensor:
    return torch.sqrt((x * x).sum(-1))


def one_hot(idx: Tensor, n: int, dtype: torch.dtype) -> Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _take(x: Tensor, index: Tensor) -> Tensor:
    """x [E, N, ...] at index [E]: [E, ...]."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, index.long()]


def nearest_k(feats: Tensor, key: Tensor, k: int) -> Tensor:
    """The rows of feats [E, N, F] in the stable ascending order of key
    [E, N], the first k of them, each times its valid column; zero rows
    fill up to k."""
    order = torch.argsort(key, dim=-1, stable=True)
    feats = torch.gather(feats, 1, order[..., None].expand(feats.shape))
    take = min(k, feats.shape[1])
    out = feats.new_zeros(feats.shape[0], k, feats.shape[-1])
    out[:, :take] = feats[:, :take] * feats[:, :take, :1]
    return out


def visible_objects_mask(
    positions: Tensor,  # [E, A, 2]
    headings: Tensor,  # [E, A]
    lengths: Tensor,  # [E, A]
    widths: Tensor,  # [E, A]
    exists: Tensor,  # [E, A] bool
    ego_index: Tensor,  # [E] int
    view_dist: float = 80.0,
    view_angle: float = VIEW_ANGLE,
    head_angle: float = 0.0,
) -> Tensor:
    """[E, A] bool: the objects visible from each scene's ego under cone and
    occlusion; the ego itself is never visible."""
    E, A, _ = positions.shape
    dev = positions.device
    ego_pos = _take(positions, ego_index)  # [E, 2]
    ego_h = _take(headings, ego_index) + head_angle
    ego_heading = angle_sub(torch.zeros_like(ego_h), -ego_h)

    corners = obb_corners(positions, headings, lengths, widths)  # [E, A, 4, 2]
    rel = corners - ego_pos[:, None, None, :]
    dist = _norm(rel)
    azimuth = torch.atan2(rel[..., 1], rel[..., 0])
    in_angle = angle_sub(ego_heading[:, None, None], azimuth).abs() <= view_angle / 2.0
    corner_in_cone = (dist <= view_dist) & in_angle  # [E, A, 4]
    in_cone = corner_in_cone.any(dim=-1)

    # blocked[e, t, b, c]: blocker b crosses the sight segment to target t's corner c
    p1 = corners[:, :, None, :, :]  # [E, T, 1, 4, 2]
    p0 = ego_pos[:, None, None, None, :]
    blocked = obb_segment_intersects(corners[:, None, :, None, :, :], p0, p1)  # [E, T, B, 4]
    ids = torch.arange(A, device=dev)
    is_blocker = (exists[:, None, :] & (ids[None, :, None] != ids[None, None, :])
                  & (ids[None, None, :] != ego_index.long()[:, None, None]))  # [E, T, B]
    corner_occluded = (blocked & is_blocker[..., None]).any(dim=2)  # [E, T, 4]
    vis = (~corner_occluded & corner_in_cone).any(dim=-1) & exists & in_cone
    return vis & (ids[None, :] != ego_index.long()[:, None])


def ego_state(
    position: Tensor,  # [..., 2]
    heading: Tensor,
    speed: Tensor,
    length: Tensor,
    width: Tensor,
    goal_position: Tensor,  # [..., 2]
) -> Tensor:
    """[..., 5]: speed, dist-to-goal, relative goal azimuth, length, width
    (scenario.cc:391-416)."""
    rel = goal_position - position
    dist = _norm(rel)
    azimuth = normalize_angle(torch.atan2(rel[..., 1], rel[..., 0]) - heading)
    return torch.stack([speed, dist, azimuth, length, width], dim=-1)


def flattened_visible_state(
    positions: Tensor,  # [E, A, 2]
    headings: Tensor,  # [E, A]
    speeds: Tensor,  # [E, A]
    lengths: Tensor,  # [E, A]
    widths: Tensor,  # [E, A]
    visible: Tensor,  # [E, A] bool (visible_objects_mask)
    ego_index: Tensor,  # [E]
    max_visible_objects: int = 16,
    agent_types: Tensor | None = None,  # [E, A] int or None
    num_agent_types: int = 5,
) -> Tensor:
    """[E, max_visible_objects, 8 (+ num_agent_types)] nearest-first
    visible-object features in the ego frame (scenario.cc:142-163
    ExtractObjectFeature)."""
    ego_pos = _take(positions, ego_index)
    ego_heading = _take(headings, ego_index)[:, None]

    rel = positions - ego_pos[:, None]
    dist = _norm(rel)
    azimuth = normalize_angle(torch.atan2(rel[..., 1], rel[..., 0]) - ego_heading)
    rel_heading = angle_sub(ego_heading, headings)
    vel = speeds[..., None] * torch.stack([torch.cos(headings), torch.sin(headings)], -1)
    rel_vel = vel - _take(vel, ego_index)[:, None]
    rel_speed = _norm(rel_vel)
    rel_vel_heading = normalize_angle(torch.atan2(rel_vel[..., 1], rel_vel[..., 0]) - ego_heading)

    feats = torch.stack(
        [visible.to(positions.dtype), dist, azimuth, lengths, widths, rel_heading, rel_vel_heading, rel_speed],
        dim=-1,
    )
    if agent_types is not None:
        feats = torch.cat([feats, one_hot(agent_types, num_agent_types, feats.dtype)], dim=-1)
    key = torch.where(visible, dist, torch.full_like(dist, math.inf))
    return nearest_k(feats, key, max_visible_objects)


def road_point_features(
    road_points: Tensor,  # [E, P, L, 3] (x, y, valid)
    road_types: Tensor,  # [E, P, 8] one-hot
    ego_pos: Tensor,  # [E, 2]
    ego_heading: Tensor,  # [E]
    blocker_corners: Tensor,  # [E, A, 4, 2]
    blocker_mask: Tensor,  # [E, A] bool: visible sight-blocking objects
    max_visible_road_points: int = 300,
    road_edge_first: bool = True,
    view_dist: float = 80.0,
    view_angle: float = VIEW_ANGLE,
    head_angle: float = 0.0,
) -> Tensor:
    """[E, max_visible_road_points, 13] nearest-K visible road-point features
    (scenario.cc:165-182): [valid, dist, azimuth, neighbor_dist,
    neighbor_azimuth, road-type one-hot (8)]. Visible = in the view cone
    and the sight segment crosses no blocker; with ``road_edge_first``
    every road-edge point ranks before every other, each group
    nearest-first. A point's neighbour is the next valid point of its row,
    else itself (the JAX function's per-row rule, which its docstring
    states as a known deviation from whole polylines)."""
    E, P, L, _ = road_points.shape
    pts = road_points[..., :2].reshape(E, P * L, 2)
    valid = (road_points[..., 2] > 0).reshape(E, P * L)
    nxt = torch.cat([road_points[:, :, 1:], road_points[:, :, -1:]], dim=2)
    nbr = torch.where(nxt[..., 2:3] > 0, nxt[..., :2], road_points[..., :2]).reshape(E, P * L, 2)
    type_idx = torch.argmax(road_types, dim=-1)
    is_pad = road_types.amax(dim=-1) <= 0
    type_idx = torch.where(is_pad, torch.zeros_like(type_idx), type_idx)
    type_flat = type_idx.repeat_interleave(L, dim=1)  # [E, P*L]
    # stop signs are static objects, never road points (stop_sign_features)
    valid = valid & ~(is_pad | (type_idx == STOP_SIGN_TYPE)).repeat_interleave(L, dim=1)

    heading = normalize_angle(ego_heading + head_angle)[:, None]
    rel = pts - ego_pos[:, None]
    dist = _norm(rel)
    azimuth = normalize_angle(torch.atan2(rel[..., 1], rel[..., 0]) - heading)
    in_cone = (dist <= view_dist) & (azimuth.abs() <= view_angle / 2.0)

    # occlusion by the visible sight-blocking objects, a chunk of blockers
    # at a time: [E, chunk, P*L, 4] intermediates instead of [E, A, P*L, 4]
    occluded = torch.zeros_like(valid)
    p0 = ego_pos[:, None, None, :]
    for a0 in range(0, blocker_corners.shape[1], BLOCKER_CHUNK):
        bc = blocker_corners[:, a0:a0 + BLOCKER_CHUNK, None]  # [E, c, 1, 4, 2]
        hit = obb_segment_intersects(bc, p0, pts[:, None])  # [E, c, P*L]
        occluded = occluded | (hit & blocker_mask[:, a0:a0 + BLOCKER_CHUNK, None]).any(dim=1)

    vis = valid & in_cone & ~occluded
    nbr_vec = nbr - pts
    nbr_dist = _norm(nbr_vec)
    nbr_azimuth = normalize_angle(torch.atan2(nbr_vec[..., 1], nbr_vec[..., 0]) - heading)
    feats = torch.cat(
        [vis[..., None].to(pts.dtype), dist[..., None], azimuth[..., None], nbr_dist[..., None],
         nbr_azimuth[..., None], one_hot(type_flat, 8, pts.dtype)],
        dim=-1,
    )
    inf = torch.full_like(dist, math.inf)
    if road_edge_first:
        not_edge = (type_flat != ROAD_EDGE_TYPE).to(pts.dtype)
        key = torch.where(vis, dist + not_edge * (2.0 * view_dist + 1e4), inf)
    else:
        key = torch.where(vis, dist, inf)
    return nearest_k(feats, key, max_visible_road_points)


def stop_sign_features(
    road_points: Tensor,  # [E, P, L, 3]
    road_types: Tensor,  # [E, P, 8]
    ego_pos: Tensor,  # [E, 2]
    ego_heading: Tensor,  # [E]
    max_visible_stop_signs: int = 4,
    view_dist: float = 80.0,
    view_angle: float = VIEW_ANGLE,
    head_angle: float = 0.0,
) -> Tensor:
    """[E, max_visible_stop_signs, 3] nearest-first stop-sign features
    (scenario.cc:196-203): [valid, dist, azimuth]. A stop sign is the first
    point of a kStopSign polyline; visible = in the view cone (stop signs
    neither block sight nor get occluded, view_field.cc:172-180)."""
    type_idx = torch.argmax(road_types, dim=-1)
    is_sign = (type_idx == STOP_SIGN_TYPE) & (road_types.amax(dim=-1) > 0)
    pos = road_points[:, :, 0, :2]
    valid = is_sign & (road_points[:, :, 0, 2] > 0)

    heading = normalize_angle(ego_heading + head_angle)[:, None]
    rel = pos - ego_pos[:, None]
    dist = _norm(rel)
    azimuth = normalize_angle(torch.atan2(rel[..., 1], rel[..., 0]) - heading)
    vis = valid & (dist <= view_dist) & (azimuth.abs() <= view_angle / 2.0)
    feats = torch.stack([vis.to(pos.dtype), dist, azimuth], dim=-1)
    key = torch.where(vis, dist, torch.full_like(dist, math.inf))
    return nearest_k(feats, key, max_visible_stop_signs)
