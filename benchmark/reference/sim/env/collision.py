"""Collision detection: dense masked all-pairs tests
(port of ``ctrl_sim_tpu/env/collision.py``; reference semantics
nocturne/cpp/src/scenario.cc:294-328 UpdateCollision)."""

from __future__ import annotations

import torch

from benchmark.reference.sim.geometry import obb_corners, obb_obb_intersects, obb_segment_hits

Tensor = torch.Tensor


def detect_collisions(
    position: Tensor,  # [E, A, 2]
    heading: Tensor,  # [E, A]
    length: Tensor,  # [E, A]
    width: Tensor,  # [E, A]
    agent_valid: Tensor,  # [E, A] bool — real (non-padding) agent slots
    seg_p0: Tensor,  # [E, S, 2]
    seg_p1: Tensor,  # [E, S, 2]
    seg_valid: Tensor,  # [E, S] bool
) -> tuple[Tensor, Tensor]:
    """Per-agent (veh_veh, veh_edge) collision flags, batched over scenes.

    Dead agents pinned at the sentinel still take part (two dead agents
    "collide" there, as in the reference evaluator); padding slots do not.
    """
    corners = obb_corners(position, heading, length, width)  # [E, A, 4, 2]
    hit = obb_obb_intersects(corners[:, :, None], corners[:, None, :])  # [E, A, A]
    A = position.shape[1]
    eye = torch.eye(A, dtype=torch.bool, device=position.device)
    pair_mask = agent_valid[:, :, None] & agent_valid[:, None, :] & ~eye
    veh_veh = (hit & pair_mask).any(dim=-1)

    seg_hit = obb_segment_hits(position, heading, length, width, seg_p0, seg_p1)
    veh_edge = (seg_hit & seg_valid[:, None, :]).any(dim=-1) & agent_valid
    return veh_veh & agent_valid, veh_edge
