"""``run_streaming`` of the DT, IL and trajeglish families and of the
default family's sequential 3-pass decode (``eval.streaming_passes=3``),
held against the JAX ``run_streaming`` under its replayed draws, f32 at the
toy config of ``torch_port_common``: the action (and RTG) logits drawn from
within 1e-4 and positions, headings, reward8, nearest distances,
existence, RTGs and controls within 1e-3 over every step, for
each family, DT with ``policy.min_return``, IL over the int8 cache and the
3-pass decode. The masks and single decode passes of these paths are held
in ``tests/test_torch_families.py``."""

import numpy as np
import pytest
import torch

from torch_port_common import family_configs, models, replay_jax_rollout, scenes, t2n

torch.set_num_threads(2)

REPLAY_CASES = {  # name: (preset, overrides)
    "dt": ("dt", {}),
    "dt-min-return": ("dt", {"policy.min_return": True}),
    "il": ("il", {}),
    "il-int8": ("il", {"model.kv_cache_dtype": "int8"}),
    "trajeglish": ("trajeglish", {}),
    "3-pass": ("ctrl_sim", {"eval.streaming_passes": 3}),
}


@pytest.mark.parametrize("case", sorted(REPLAY_CASES))
def test_rollout_replay_matches_jax(case):
    """Under the JAX rollout's draws (its action ids, and for the 3-pass
    default family its RTG bins; the other families sample no returns) the
    port's ``run_streaming`` draws from the same logits at every step
    (1e-4, the decode passes' tolerance) and follows the same trajectories
    over all 16 steps (the window of 8 wraps)."""
    family, over = REPLAY_CASES[case]
    jcfg, tcfg = family_configs(family, **over)
    sb = scenes(jcfg, num_scenes=4, num_agents=8)
    jm, params, tm = models(jcfg, tcfg)
    logits = {}
    ro, out = replay_jax_rollout(jcfg, tcfg, sb, tm, params, jm, logits=logits)
    assert len(logits["actions"]) == tcfg.sim.steps
    assert len(logits["rtgs"]) == (tcfg.sim.steps if tcfg.policy.predict_rtgs else 0)
    for name in ("actions", "rtgs"):
        assert len(logits[name]) == len(logits[f"jax_{name}"]), name
        for t, (got, want) in enumerate(zip(logits[name], logits[f"jax_{name}"])):
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=f"{name} logits t={t}")
    assert (ro.acceleration[tcfg.sim.history_steps:][:, sb.moving & sb.agent_valid] != 0).any()
    assert (np.abs(ro.rtgs).sum() > 0) == tcfg.policy.predict_rtgs
    for name in ("position", "heading", "reward8", "nearest_dist", "existence", "rtgs", "acceleration", "steering"):
        np.testing.assert_allclose(t2n(getattr(out, name)), getattr(ro, name), atol=1e-3, rtol=0, err_msg=name)
