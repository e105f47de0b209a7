"""The port's exact-mode rollout ``run_closed_loop`` held against the JAX
``run_closed_loop`` under its replayed draws, at the toy config of
``torch_port_common`` (f32, contacts off, window 8 over 16 steps): the
RTG and action logits each side draws from within 1e-4 at every step, and
positions, headings, reward8, nearest distances, existence, RTGs and
controls within 1e-3, for a multi-group case (20 agents over the 12-slot crop, two or more
focal groups a scene) and the same padded by one empty group; and one bf16
case at the tolerances of ``tests/test_torch_bf16.py``'s training forward
(logits 0.05) and rollout (trajectories 1e-3). An empty group lane stays
finite and changes nothing."""

import numpy as np
import pytest
import torch

from ctrl_sim_tpu_torch.rollout.groups import build_focal_groups, pad_groups
from ctrl_sim_tpu_torch.rollout.rollout import run_closed_loop
from torch_closed_loop_common import MULTIGROUP, MULTIGROUP_CONTROLLED, STREAMS, assert_replay_matches, \
    multigroup_scenes, stable_jax_group_sort
from torch_port_common import family_configs, models, t2n, torch_scenario

torch.set_num_threads(2)

CASE_NAMES = ["multigroup", "multigroup-padded", "bf16"]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_closed_loop_replay_matches_jax(case, monkeypatch):
    stable_jax_group_sort(monkeypatch)
    assert_replay_matches(case)


def test_padded_group_lane_changes_nothing():
    """An empty group lane stays finite and changes nothing: the padded
    rollout equals the unpadded one under the same draws."""
    jcfg, tcfg = family_configs("ctrl_sim", **{"eval.agent_slots": 0, **MULTIGROUP})
    sb = multigroup_scenes(jcfg, num_scenes=2)
    _, _, tm = models(jcfg, tcfg)
    controlled = np.asarray(sb.moving & sb.agent_valid).copy()
    controlled[:, MULTIGROUP_CONTROLLED] = True
    inputs = (np.asarray(sb.traj_position), np.asarray(sb.traj_valid).astype(bool),
              np.asarray(sb.agent_valid).astype(bool), controlled)
    groups = build_focal_groups(tcfg, *inputs, device="cpu")
    sc, ctl = torch_scenario(sb), torch.as_tensor(controlled)
    base = run_closed_loop(tcfg, tm, sc, ctl, torch.Generator().manual_seed(3), groups=groups)
    padded = run_closed_loop(tcfg, tm, sc, ctl, torch.Generator().manual_seed(3),
                             groups=pad_groups(groups, groups.num_groups + 1))
    for name in STREAMS:
        np.testing.assert_array_equal(t2n(getattr(padded, name)), t2n(getattr(base, name)), err_msg=name)
