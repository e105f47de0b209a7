"""The CTG++ closed loop with contacts on and guidance on, held against
the JAX package under its replayed draws (the set-up of
``tests/test_torch_ctg_rollout.py``, ``torch_port_common.ctg_loop_setup``; the JAX contact geometry given the
port's tie rule for corners of equal key, ``patch_jax_contact_tie_rule``,
ROADMAP §3 item 3), within 1e-4; then the evaluation path:
``PolicyEvaluator`` dispatches a CTG++ config to ``run_ctg_closed_loop``
without focal groups, and ``eval_sim --preset ctg_plus_plus --synthetic 2
--device cpu`` gives finite metrics."""

import math

import numpy as np
import torch

from ctrl_sim_tpu_torch import eval_sim
from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario
from ctrl_sim_tpu_torch.evals.evaluator import PolicyEvaluator
from ctrl_sim_tpu_torch.training import CTGTrainer
from torch_port_common import (
    CTG_LOOP as LOOP,
    CTG_TOY,
    assert_ctg_rollouts_match,
    ctg_configs,
    ctg_loop_setup,
    patch_jax_contact_tie_rule,
    replayed_ctg_rollouts,
)

torch.set_num_threads(2)


def test_closed_loop_with_contacts_and_guidance_matches_jax(monkeypatch):
    patch_jax_contact_tie_rule(monkeypatch)
    case = ctg_loop_setup(**{"sim.resolve_contacts": True, "policy.ctg_goal_guidance": 1.0,
                         "policy.ctg_collision_guidance": 1.0})
    ro, out = replayed_ctg_rollouts(*case)
    assert_ctg_rollouts_match(ro, out)


def test_policy_evaluator_runs_the_ctg_loop():
    """The evaluator's CTG++ branch: no focal groups, lanes of exactly
    max_num_agents slots, metrics finite and seeded."""
    _, tcfg = ctg_configs(**LOOP)
    model = CTGTrainer(tcfg, device="cpu").init_state(torch.Generator().manual_seed(0)).model.eval()
    scenes = [synthetic_scenario(tcfg, seed=s, num_agents=4, arena_half=60.0, num_lanes=2) for s in range(3)]
    ev = PolicyEvaluator(tcfg, model, lane_batch=2, device="cpu")
    assert all(groups is None for _, _, groups in ev.chunks(scenes))
    a, b = ev.evaluate(scenes), ev.evaluate(scenes)
    assert a and a == b
    assert all(math.isfinite(v) for v in a.values()), a


def test_eval_sim_cli_ctg(capsys):
    overrides = {**CTG_TOY, **LOOP, "model.n_diffusion_steps": 4, "model.n_eval_diffusion_step": 2}
    flags = [x for k, v in overrides.items() for x in ("-o", f"{k}={v}")]
    metrics = eval_sim.main(["--preset", "ctg_plus_plus", "--synthetic", "2", "--synthetic_agents", "4",
                             "--device", "cpu", *flags])
    for k in ("goal", "collision_rate", "offroad_rate", "ade", "fde"):
        assert k in metrics and np.isfinite(metrics[k]), (k, metrics)
    assert '"ade"' in capsys.readouterr().out
