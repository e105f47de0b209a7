"""Focal groups of the closed-loop rollouts (port of
``ctrl_sim_tpu/rollout/groups.py``).

A group is a fixed-shape index map from model slots to scene agents;
``gather_members`` reads per-agent data into the slots and
``scatter_by_rank`` resolves the cross-group dedup (lower group rank wins,
autoregressive_policy.py:185-207). Scenes with more agents than one model
crop are split into focal groups on the host at t = 0
(``build_focal_groups``, the reference's greedy construction of
autoregressive_policy.py:88-137): the evaluated vehicles sorted by GT
trajectory length, longest first, each still unaccounted one becomes the
focal of a group of the <= crop agents nearest to it within 60 m, and
every unaccounted evaluated vehicle inside that crop is assigned to it.
Two documented deviations of the JAX package are kept: every contained
vehicle is assigned (the reference's loop skips one after each hit), and a
group whose focal dies keeps its members and re-elects its origin.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.device import resolve_device

Tensor = torch.Tensor


class GroupSpec(NamedTuple):
    """Fixed-shape focal groups. Pad slots carry ``members == A_sim``."""

    members: Tensor  # [E, G, Am] long — original agent index per slot
    member_valid: Tensor  # [E, G, Am] bool
    assigned: Tensor  # [E, G, Am] bool — evaluated vehicles owned by the group
    group_valid: Tensor  # [E, G] bool
    gt_length: Tensor  # [E, A_sim] float32 — GT existence length (origin key)

    @property
    def num_groups(self) -> int:
        return self.members.shape[1]

    @property
    def crop_size(self) -> int:
        return self.members.shape[2]


def build_focal_groups(
    cfg: Config,
    traj_position: np.ndarray,  # [E, A_sim, T+1, 2]
    traj_valid: np.ndarray,  # [E, A_sim, T+1] bool
    agent_valid: np.ndarray,  # [E, A_sim] bool
    controlled: np.ndarray,  # [E, A_sim] bool
    min_groups: int = 1,
    crop_size: int | None = None,
    device: torch.device | str | None = None,
) -> GroupSpec:
    """The focal groups of each scene, from its t = 0 GT state only, built
    in numpy and returned as tensors on ``device`` (the card unless the
    caller passes ``device="cpu"``). ``crop_size`` below
    ``waymo.max_num_agents`` builds packed crops for the streaming rollout
    (``eval.agent_slots``)."""
    wc = cfg.waymo
    Am = crop_size or wc.max_num_agents
    E, A_sim = controlled.shape
    lengths = traj_valid.sum(axis=2).astype(np.float32)  # [E, A_sim]

    per_scene: list[list[tuple[np.ndarray, list[int]]]] = []
    for e in range(E):
        pos0 = traj_position[e, :, 0]
        exist0 = traj_valid[e, :, 0] & agent_valid[e]
        evaluated = [int(i) for i in np.where(controlled[e])[0]]
        # longest GT trajectory first: the stable ascending argsort reversed,
        # so ties go to the higher index first, as in the reference
        order = np.argsort(np.array([lengths[e, v] for v in evaluated]), kind="stable")[::-1]
        unaccounted = [evaluated[i] for i in order]
        groups: list[tuple[np.ndarray, list[int]]] = []
        while unaccounted:
            focal = unaccounted.pop(0)
            if not exist0[focal]:  # a focal dead at t = 0 never acts
                continue
            # the <= Am closest agents within the radius, in original-index order
            dist = np.linalg.norm(pos0 - pos0[focal][None], axis=-1)
            in_range = (dist < wc.agent_dist_threshold) & exist0
            closest = np.argsort(dist, kind="stable")[:Am]
            members = np.intersect1d(closest, np.where(in_range)[0])
            member_set = set(members.tolist())
            assigned = [focal] + [v for v in unaccounted if v in member_set]
            assigned_set = set(assigned)
            unaccounted = [v for v in unaccounted if v not in assigned_set]
            groups.append((members, assigned))
        per_scene.append(groups)

    G = max(min_groups, max((len(g) for g in per_scene), default=1))
    members = np.full((E, G, Am), A_sim, dtype=np.int64)
    member_valid = np.zeros((E, G, Am), dtype=bool)
    assigned_m = np.zeros((E, G, Am), dtype=bool)
    group_valid = np.zeros((E, G), dtype=bool)
    for e, groups in enumerate(per_scene):
        for g, (mem, assigned) in enumerate(groups):
            n = len(mem)
            members[e, g, :n] = mem
            member_valid[e, g, :n] = True
            group_valid[e, g] = True
            assigned_m[e, g, :n] = np.isin(mem, assigned)
    dev = resolve_device(device)
    return GroupSpec(*(torch.as_tensor(x, device=dev)
                       for x in (members, member_valid, assigned_m, group_valid, lengths)))


def pad_groups(spec: GroupSpec, num_groups: int) -> GroupSpec:
    """The group axis padded to ``num_groups`` with invalid groups (empty
    lanes that change nothing), so that every chunk of an evaluation has
    one shape."""
    E, G, Am = spec.members.shape
    if G >= num_groups:
        return spec
    A_sim = spec.gt_length.shape[1]

    def padg(x: Tensor, fill) -> Tensor:
        extra = torch.full((E, num_groups - G) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, extra], dim=1)

    return GroupSpec(
        members=padg(spec.members, A_sim),
        member_valid=padg(spec.member_valid, False),
        assigned=padg(spec.assigned, False),
        group_valid=padg(spec.group_valid, False),
        gt_length=spec.gt_length,
    )


def trivial_groups(
    cfg: Config,
    origin_idx: Tensor,  # [E]
    relevant0: Tensor,  # [E, A] bool
    controlled_mask: Tensor,  # [E, A] bool
    gt_length: Tensor,  # [E, A]
) -> GroupSpec:
    """Single-group spec for scenes already at the model crop size: members
    are the identity map, membership the t=0 relevant set."""
    del cfg, origin_idx
    E, A = controlled_mask.shape
    idx = torch.arange(A, device=relevant0.device).expand(E, 1, A)
    mv = relevant0[:, None, :]
    return GroupSpec(
        members=torch.where(mv, idx, A),
        member_valid=mv,
        assigned=(controlled_mask & relevant0)[:, None, :],
        group_valid=controlled_mask.any(dim=1, keepdim=True),
        gt_length=gt_length.float(),
    )


def packed_trivial_groups(
    cfg: Config,
    origin_idx: Tensor,  # [E]
    relevant0: Tensor,  # [E, A] bool — in-range agents at t=0
    controlled_mask: Tensor,  # [E, A] bool
    gt_length: Tensor,  # [E, A]
    dist0: Tensor,  # [E, A] — distance to the origin at t=0
    crop_size: int,
) -> GroupSpec:
    """Single-group spec packed into ``crop_size`` slots: the ``crop_size``
    closest in-range agents (ties: lower index first), in original-index
    order in the leading slots. Agents beyond the crop are dropped from the
    group; controlled ones then fall back to GT replay."""
    del cfg, origin_idx
    E, A = controlled_mask.shape
    dev = relevant0.device
    rank = torch.argsort(dist0.masked_fill(~relevant0, float("inf")), dim=1, stable=True)
    keep = torch.zeros((E, A), dtype=torch.bool, device=dev)
    keep.scatter_(1, rank[:, :crop_size], True)
    keep &= relevant0
    idx = torch.arange(A, device=dev)
    key = torch.where(keep, idx[None, :], A + idx[None, :])
    order = torch.argsort(key, dim=1)[:, :crop_size]  # keys are distinct
    valid = torch.gather(keep, 1, order)
    return GroupSpec(
        members=torch.where(valid, order, A)[:, None, :],
        member_valid=valid[:, None, :],
        assigned=torch.gather(controlled_mask & keep, 1, order)[:, None, :],
        group_valid=controlled_mask.any(dim=1, keepdim=True),
        gt_length=gt_length.float(),
    )


def gather_members(x: Tensor, members: Tensor) -> Tensor:
    """Per-agent data [E, A_sim, ...] -> group slots [E, G, Am, ...]. Pad
    slots (members == A_sim) read the last row; callers mask them."""
    E, G, Am = members.shape
    safe = members.clamp(max=x.shape[1] - 1).reshape(E, G * Am)
    idx = safe.reshape((E, G * Am) + (1,) * (x.dim() - 2)).expand((E, G * Am) + x.shape[2:])
    return torch.gather(x, 1, idx).reshape((E, G, Am) + x.shape[2:])


def scatter_by_rank(
    values: Tensor,  # [E, G, Am, ...]
    members: Tensor,  # [E, G, Am] (A_sim = drop sentinel)
    contrib: Tensor,  # [E, G, Am] bool
    num_agents: int,
) -> tuple[Tensor, Tensor]:
    """Group values -> an [E, num_agents, ...] table, LOWER group rank
    winning. Returns (table, covered)."""
    E, G, Am = members.shape
    dev = values.device
    table = torch.zeros((E, num_agents + 1) + values.shape[3:], dtype=values.dtype, device=dev)
    covered = torch.zeros((E, num_agents + 1), dtype=torch.bool, device=dev)
    rows = torch.arange(E, device=dev)[:, None]
    # later writes win: go from the highest rank down so rank 0 lands last;
    # the extra row num_agents takes the dropped writes
    for g in range(G - 1, -1, -1):
        idx = torch.where(contrib[:, g], members[:, g], num_agents)
        table[rows, idx] = values[:, g]
        covered[rows, idx] = True
    return table[:, :num_agents], covered[:, :num_agents]
