"""The port's CTG++ closed loop (``rollout/ctg_rollout.py``) held against
the JAX ``run_ctg_closed_loop`` on the same scenes and weights (the
executed reference's denoiser, ``torch_port_common.ctg_models``), in f32:
2 scenes of 4 agents, 20 steps with a history of 10, so the policy replans
at steps 9, 14 and 19, contacts off. The JAX rollout runs with its own
keys; the port's replays the sampler draws of the JAX key schedule
(``torch_port_common.jax_ctg_rollout_noise``). The applied actions of
every step (the controlled agents' planned ones from step 9 on) and the
trajectories agree within 1e-4, which also holds the reproduced key
schedule right. The map and edge encodings computed once a replan equal
the denoiser's own at every call. ``tests/test_torch_ctg_eval.py`` holds
the contacts-on case and the evaluation CLI."""

import numpy as np
import pytest
import torch

from ctrl_sim_tpu_torch.rollout.ctg_rollout import replan_steps, run_ctg_closed_loop
from torch_port_common import (
    CTG_LOOP as LOOP,
    assert_ctg_rollouts_match,
    ctg_configs,
    ctg_loop_setup,
    replayed_ctg_rollouts,
    scenes,
    torch_scenario,
)

torch.set_num_threads(2)


def test_replan_steps():
    _, tcfg = ctg_configs(**LOOP)
    assert replan_steps(tcfg) == [9, 14, 19]
    _, tcfg = ctg_configs(**{**LOOP, "sim.steps": 90})
    assert len(replan_steps(tcfg)) == 17


def test_closed_loop_matches_jax_under_its_draws():
    *_, controlled = case = ctg_loop_setup()
    assert controlled.any()
    ro, out = replayed_ctg_rollouts(*case)
    assert_ctg_rollouts_match(ro, out)
    # the controlled agents follow the plans from step 9 on, and the plans differ between replans
    acc = ro.acceleration[9:][:, controlled]
    assert np.abs(acc).max() > 0 and not np.allclose(acc[:5], acc[5:10])


def test_closed_loop_draws_from_its_generator():
    """Without replayed draws the rollout is seeded by its generator."""
    _, tcfg, sb, _, _, tm, controlled = ctg_loop_setup()
    sc, ctrl = torch_scenario(sb), torch.as_tensor(controlled)
    a, b, c = (run_ctg_closed_loop(tcfg, tm, sc, ctrl, torch.Generator().manual_seed(s)) for s in (3, 3, 4))
    for x in a:
        assert torch.isfinite(x.float()).all()
    assert torch.equal(a.position, b.position) and not torch.equal(a.position, c.position)
    # lanes must hold exactly max_num_agents slots (no focal groups)
    wide = scenes(ctg_configs(**{**LOOP, "sim.max_agents": 5})[0], 1, num_agents=4)
    with pytest.raises(ValueError, match="max_num_agents"):
        run_ctg_closed_loop(tcfg, tm, torch_scenario(wide), torch.as_tensor(wide.agent_valid), None)
