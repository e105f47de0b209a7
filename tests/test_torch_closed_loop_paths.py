"""The port's exact-mode rollout ``run_closed_loop`` held against the JAX
``run_closed_loop`` under its replayed draws, at the toy config of
``torch_port_common`` (f32, window 8 over 16 steps), on the three paths
the other closed-loop tests leave out: trajeglish, DT without
``policy.min_return``, and CtRL-Sim with the contact solver on (the eval
default; the toy config turns it off). The RTG and action logits each
side draws from within 1e-4 at every step, and positions, headings,
reward8, nearest distances, existence, RTGs and controls within 1e-3. The
contacts case gives the JAX contact geometry the port's tie rule for tied
incident-edge corners (``patch_jax_contact_tie_rule``), as the contact
tests do: the two packages order such corners differently, a stated
difference."""

import pytest
import torch

from torch_closed_loop_common import CASES, assert_replay_matches, stable_jax_group_sort
from torch_port_common import patch_jax_contact_tie_rule

torch.set_num_threads(2)

CASE_NAMES = ["trajeglish", "dt", "contacts"]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_closed_loop_replay_matches_jax(case, monkeypatch):
    stable_jax_group_sort(monkeypatch)
    if CASES[case][1].get("sim.resolve_contacts"):
        patch_jax_contact_tie_rule(monkeypatch)
    assert_replay_matches(case)
