"""The port's exact-mode rollout ``run_closed_loop`` held against the JAX
``run_closed_loop`` under its replayed draws, at the toy config of
``torch_port_common`` (f32, contacts off, window 8 over 16 steps): the
RTG and action logits each side draws from within 1e-4 at every step, and
positions, headings, reward8, nearest distances, existence, RTGs and
controls within 1e-3, for CtRL-Sim, DT with ``policy.min_return``, IL and per-agent tilts
[E, A, bins, 3]; the multi-group and bf16 cases are in
``tests/test_torch_closed_loop_groups.py``."""

import pytest
import torch

from torch_closed_loop_common import assert_replay_matches, stable_jax_group_sort

torch.set_num_threads(2)

CASE_NAMES = ["ctrl_sim", "dt-min-return", "il", "per-agent-tilt"]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_closed_loop_replay_matches_jax(case, monkeypatch):
    stable_jax_group_sort(monkeypatch)
    assert_replay_matches(case)
