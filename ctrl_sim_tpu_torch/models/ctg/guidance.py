"""CTG++ diffusion guidance: goal and collision costs (port of
``ctrl_sim_tpu/models/ctg/guidance.py``).

The reference names ``GoalGuide`` / ``CollisionGuide`` but ships no
diffusion_guidance module (modules/diffusion.py:14); the JAX package makes
the interface real, and so does the port: differentiable costs over the
diffused futures whose gradients nudge the denoised mean
(``GaussianDiffusion.sample(guidance_fn=...)``, ``torch.autograd.grad`` in
place of ``jax.grad``).

Diffused layout: ``x [B, N, T_out, 7]`` = each agent's local-frame [x, y,
vx, vy, yaw] (positions / ``pos_div``, velocities / ``vel_div``), then 2
normalized actions. Goals in ``cond["goals"]`` are in the same local units;
the collision cost maps local positions back to the global frame through
the anchor states the rollout holds.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Tensor = torch.Tensor
GuidanceFn = Callable[[Tensor, dict], Tensor]


def _exist_mask(cond: dict) -> Tensor:
    """[B, N] existence at the present step, times the moving mask."""
    exist = cond["agent_past_states"][..., -1, -1]
    moving = cond.get("moving_agent_mask")
    return exist * (moving if moving is not None else torch.ones_like(exist))


def goal_guide(weight: float = 1.0) -> GuidanceFn:
    """Mean squared distance between each agent's final diffused position
    and its goal, both in the agent's normalized local frame."""

    def cost(x: Tensor, cond: dict) -> Tensor:
        final = x[..., -1, :2]
        goal = cond["goals"][..., :2]
        m = _exist_mask(cond)
        d2 = ((final - goal) ** 2).sum(dim=-1)
        return weight * (d2 * m).sum() / m.sum().clamp(min=1.0)

    return cost


def local_to_global(pos_local: Tensor, anchor: Tensor, pos_div: float) -> Tensor:
    """Invert the per-agent local frame (data/ctg_pipeline.py): local =
    R(rot) (global - t) with rot = pi/2 + sign(-yaw) |yaw|, so global =
    R(-rot) local + t. pos_local [B, N, T, 2] normalized; anchor [B, N, 8]."""
    yaw = anchor[..., 4]
    rot = (math.pi / 2) + torch.sign(-yaw) * yaw.abs()
    p = pos_local * pos_div
    c, s = torch.cos(-rot)[..., None], torch.sin(-rot)[..., None]
    unrot = torch.stack([c * p[..., 0] - s * p[..., 1], s * p[..., 0] + c * p[..., 1]], dim=-1)
    return unrot + anchor[..., None, :2]


def collision_guide(anchor: Tensor, pos_div: float, radius: float = 4.0, weight: float = 1.0) -> GuidanceFn:
    """Pairwise proximity penalty over the diffused futures: pairs closer
    than ``radius`` at a future step pay (radius - d)^2, averaged over the
    pairs of existing agents. ``anchor`` [B, N, 8] are the present states
    in the global frame."""

    def cost(x: Tensor, cond: dict) -> Tensor:
        gpos = local_to_global(x[..., :2], anchor, pos_div)  # [B, N, T, 2]
        m = _exist_mask(cond)
        diff = gpos[:, :, None] - gpos[:, None, :]  # [B, N, N, T, 2]
        d = torch.sqrt((diff ** 2).sum(dim=-1) + 1e-9)
        N = d.shape[1]
        ar = torch.arange(N, device=x.device)
        pair = ((ar[:, None] < ar[None, :])[None, :, :, None] & (m[:, :, None, None] > 0)
                & (m[:, None, :, None] > 0))
        pen = torch.where(pair, (radius - d).clamp(min=0.0) ** 2, 0.0)
        return weight * pen.sum() / pair.float().sum().clamp(min=1.0)

    return cost


def combine(*fns: GuidanceFn) -> GuidanceFn:
    """The sum of several guidance costs."""

    def cost(x: Tensor, cond: dict) -> Tensor:
        total = torch.zeros((), device=x.device)
        for f in fns:
            total = total + f(x, cond)
        return total

    return cost
