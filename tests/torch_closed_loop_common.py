"""Shared set-up of the tests that hold the port's exact-mode rollout and
evaluators against the JAX package: scenes with more agents than the model
crop, the JAX samplers' draws recorded by a host callback, and a sampler
that replays them through the port."""

from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ctrl_sim_tpu.data import stack_scenarios as jax_stack, synthetic_scenario as jax_synth
from ctrl_sim_tpu.rollout import rollout as jax_rollout
from ctrl_sim_tpu.rollout.groups import build_focal_groups as jax_build_groups, pad_groups as jax_pad_groups
from ctrl_sim_tpu_torch.rollout.groups import build_focal_groups, pad_groups
from ctrl_sim_tpu_torch.rollout.rollout import run_closed_loop
from torch_port_common import family_configs, jax_scenario, models, scenes, t2n, torch_scenario

# the toy config with a scene of 20 agents in the env over the 12-slot crop
MULTIGROUP = {"sim.max_agents": 20, "eval.agent_slots": 0}
MULTIGROUP_CONTROLLED = [0, 3, 15, 17]  # controlled besides the movers: both clusters


def multigroup_scenes(cfg, num_scenes: int = 2, num_agents: int = 20, far: int = 14, seed0: int = 0):
    """Stacked numpy scenes of ``num_agents`` agents whose agents ``far``
    and up are moved 200 m away: two clusters, the first larger than the
    model crop, so the focal groups split each scene."""
    out = []
    for s in range(num_scenes):
        sc = jax_synth(cfg, seed=seed0 + s, num_agents=num_agents, arena_half=60.0, num_lanes=2)
        tp, gp = sc.traj_position.copy(), sc.goal_position.copy()
        tp[far:] += 200.0
        gp[far:] += 200.0
        out.append(dataclasses.replace(sc, traj_position=tp, goal_position=gp))
    return jax_stack(out, cfg)


class _StableNumpy:
    """numpy with ``argsort`` stable by default."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def argsort(a, axis=-1, kind="stable", **kwargs):
        return np.argsort(a, axis=axis, kind=kind, **kwargs)


def stable_jax_group_sort(monkeypatch) -> None:
    """Give the JAX ``build_focal_groups``, for one test, the stable sort
    its comment documents (ctrl_sim_tpu/rollout/groups.py:100-103: ties of
    GT length go to the higher index first). It calls ``np.argsort``
    without ``kind``, numpy's default quicksort, which is not stable: on a
    CPU with AVX-512 numpy 2 sorts float32 keys with a vectorized sort that
    orders ties as it finds them. The port sorts stably, as the comment
    says, so both agree on any CPU only with this patch."""
    from ctrl_sim_tpu.rollout import groups as jgroups

    monkeypatch.setattr(jgroups, "np", _StableNumpy())


@contextlib.contextmanager
def record_jax_draws(module):
    """Inside, the JAX rollout module ``module``'s samplers report every
    draw (action ids [E, A], RTG bins [E, A, 3]) and the logits it was
    drawn from, in order, into the yielded dict's lists "actions", "rtgs",
    "action_logits" and "rtg_logits" (host callbacks in the jitted
    rollout)."""
    rec = {"actions": [], "rtgs": [], "action_logits": [], "rtg_logits": []}

    def recording(sampler, key):
        def draw(rng, table_logits, *args):
            out = sampler(rng, table_logits, *args)

            def keep(logits, value):
                rec[f"{key}_logits"].append(np.asarray(logits))
                rec[f"{key}s"].append(np.asarray(value))
            jax.debug.callback(keep, table_logits, out, ordered=True)
            return out
        return draw

    with mock.patch.object(module, "sample_actions", recording(module.sample_actions, "action")), \
            mock.patch.object(module, "sample_tilted_rtgs", recording(module.sample_tilted_rtgs, "rtg")):
        yield rec


class DrawReplay:
    """Hands out given draws, step by step (RTG bins [E, A, 3] and action
    ids [E, A] a step), and keeps the logits the port draws from."""

    def __init__(self, actions: list, rtgs: list, device="cpu"):
        self._actions = [torch.as_tensor(np.array(a), device=device).long() for a in actions]
        self._rtgs = [torch.as_tensor(np.array(r), device=device).long() for r in rtgs]
        self.action_logits, self.rtg_logits = [], []

    def rtgs(self, t, logits, tilt):
        assert torch.isfinite(logits.float()).all()
        self.rtg_logits.append(t2n(logits.float()))
        return self._rtgs[t]

    def actions(self, t, logits):
        assert torch.isfinite(logits.float()).all()
        self.action_logits.append(t2n(logits.float()))
        return self._actions[t]


def split_replays(rec: dict, steps: int, predict_rtgs: bool, chunks: int) -> list[DrawReplay]:
    """The recorded draws of ``chunks`` consecutive rollouts of ``steps``
    steps, one ``DrawReplay`` each."""
    out = []
    for c in range(chunks):
        acts = rec["actions"][c * steps:(c + 1) * steps]
        rtgs = rec["rtgs"][c * steps:(c + 1) * steps] if predict_rtgs else []
        out.append(DrawReplay(acts, rtgs))
    return out


STREAMS = ("position", "heading", "reward8", "nearest_dist", "existence", "rtgs", "acceleration", "steering")
CASES = {  # name: (preset, overrides, scene kind, groups: None | "built" | "padded", per-agent tilt)
    "ctrl_sim": ("ctrl_sim", {}, "toy", None, False),
    "dt-min-return": ("dt", {"policy.min_return": True}, "toy", None, False),
    "il": ("il", {}, "toy", None, False),
    "per-agent-tilt": ("ctrl_sim", {}, "toy", None, True),
    "multigroup": ("ctrl_sim", MULTIGROUP, "multigroup", "built", False),
    "multigroup-padded": ("ctrl_sim", MULTIGROUP, "multigroup", "padded", False),
    "bf16": ("ctrl_sim", {"model.compute_dtype": "bfloat16"}, "toy", None, False),
    "trajeglish": ("trajeglish", {}, "toy", None, False),
    "dt": ("dt", {}, "toy", None, False),
    "contacts": ("ctrl_sim", {"sim.resolve_contacts": True}, "toy", None, False),
}


def _tilt(case_tilt: bool, E: int, A: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    shape = (E, A, 350, 3) if case_tilt else (350, 3)
    return rng.normal(size=shape).astype(np.float32)


def replay_closed_loop(case: str):
    """Both rollouts from the same scenes and weights, the port's under
    the JAX rollout's recorded draws; returns (config, JAX output, port
    output, recorded JAX draws and logits, the port's sampler)."""
    family, over, kind, groups_kind, per_agent = CASES[case]
    jcfg, tcfg = family_configs(family, **{"eval.agent_slots": 0, **over})
    if kind == "multigroup":
        sb = multigroup_scenes(jcfg, num_scenes=2)
    else:
        sb = scenes(jcfg, num_scenes=4, num_agents=8)
    jm, params, tm = models(jcfg, tcfg)
    controlled = np.asarray(sb.moving & sb.agent_valid)
    if kind == "multigroup":
        controlled = controlled.copy()
        controlled[:, MULTIGROUP_CONTROLLED] = True
    E, A = controlled.shape
    tilt = _tilt(per_agent, E, A)
    jgroups = tgroups = None
    if groups_kind:
        inputs = (np.asarray(sb.traj_position), np.asarray(sb.traj_valid).astype(bool),
                  np.asarray(sb.agent_valid).astype(bool), controlled)
        jgroups, tgroups = jax_build_groups(jcfg, *inputs), build_focal_groups(tcfg, *inputs, device="cpu")
        assert jgroups.members.shape[1] >= 2
        if groups_kind == "padded":
            G = jgroups.members.shape[1] + 1
            jgroups, tgroups = jax_pad_groups(jgroups, G), pad_groups(tgroups, G)
        jgroups = jax.tree.map(jnp.asarray, jgroups)
    with record_jax_draws(jax_rollout) as rec:
        ro = jax.jit(lambda s, p, c, r, tl, g: jax_rollout.run_closed_loop(jcfg, jm, p, s, c, r, tl, groups=g))(
            jax_scenario(sb), params, jnp.asarray(controlled), jax.random.PRNGKey(1), jnp.asarray(tilt), jgroups)
        ro = jax.tree.map(np.array, ro)
    sampler = DrawReplay(rec["actions"], rec["rtgs"])
    out = run_closed_loop(tcfg, tm, torch_scenario(sb), torch.as_tensor(controlled), None, torch.as_tensor(tilt),
                          groups=tgroups, sampler=sampler)
    return tcfg, ro, out, rec, sampler


def assert_replay_matches(case: str) -> None:
    """``replay_closed_loop(case)``: the logits drawn from within 1e-4
    (bf16: 0.05) at every step and the streams within 1e-3."""
    bf16 = CASES[case][1].get("model.compute_dtype") == "bfloat16"
    tcfg, ro, out, rec, sampler = replay_closed_loop(case)
    steps = tcfg.sim.steps
    assert len(sampler.action_logits) == len(rec["action_logits"]) == steps
    assert len(sampler.rtg_logits) == len(rec["rtg_logits"]) == (steps if tcfg.policy.predict_rtgs else 0)
    tol = 0.05 if bf16 else 1e-4
    for name in ("action", "rtg"):
        for t, (got, want) in enumerate(zip(getattr(sampler, f"{name}_logits"), rec[f"{name}_logits"])):
            np.testing.assert_allclose(got, want, atol=tol, rtol=0 if bf16 else 1e-4, err_msg=f"{name} logits t={t}")
    controlled = t2n(out.controlled_mask)
    assert (ro.acceleration[tcfg.sim.history_steps:][:, controlled] != 0).any()
    assert (np.abs(ro.rtgs).sum() > 0) == tcfg.policy.predict_rtgs
    for name in STREAMS:
        np.testing.assert_allclose(t2n(getattr(out, name)), getattr(ro, name), atol=1e-3, rtol=0, err_msg=name)
