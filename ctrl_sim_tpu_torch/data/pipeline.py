"""Goal vectors of a scene (port of ``goals_from_scenario``,
``ctrl_sim_tpu/data/pipeline.py:24``)."""

from __future__ import annotations

import torch

from ctrl_sim_tpu_torch.data.scenario import Scenario


def goals_from_scenario(scenario: Scenario) -> torch.Tensor:
    """[E, A, 5] goal vectors (x, y, vx, vy, heading) — extract_rawdata's
    goal layout (dataset.py:160-167). ``scenario`` holds tensors."""
    gp = scenario.goal_position
    gh = scenario.goal_heading
    gs = scenario.goal_speed
    return torch.cat(
        [gp, (gs * torch.cos(gh))[..., None], (gs * torch.sin(gh))[..., None], gh[..., None]],
        dim=-1,
    )
