"""Focal groups of the closed-loop rollouts (port of
``ctrl_sim_tpu/rollout/groups.py``).

A group is a fixed-shape index map from model slots to scene agents;
``gather_members`` reads per-agent data into the slots and
``scatter_by_rank`` resolves the cross-group dedup (lower group rank wins,
autoregressive_policy.py:185-207). The benchmark's rollouts run one
group a scene (``trivial_groups``, ``packed_trivial_groups``); the focal
groups of larger scenes are the port's alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.sim.config import Config

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
