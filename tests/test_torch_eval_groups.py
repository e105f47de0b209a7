"""The port's focal groups and evaluation vehicle selection held against the
JAX package bit for bit: ``build_focal_groups`` / ``pad_groups`` on scenes
with more agents than the model crop, a focal vehicle dead at t = 0 and
ties of GT trajectory length, and ``select_vehicles_to_evaluate`` (with
the evaluator's chunks) in every ``eval.eval_mode``.

The JAX ``build_focal_groups`` sorts the lengths with numpy's default
(unstable) argsort while its comment documents the stable order; the
comparisons give it the stable sort (``stable_jax_group_sort``) and one
test pins the documented tie rule on the port alone."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from ctrl_sim_tpu.evals import evaluator as jev
from ctrl_sim_tpu.rollout.groups import build_focal_groups as jax_build_groups, pad_groups as jax_pad_groups
from ctrl_sim_tpu_torch.evals import evaluator as tev
from ctrl_sim_tpu_torch.rollout.groups import build_focal_groups, pad_groups
from torch_closed_loop_common import MULTIGROUP, multigroup_scenes, stable_jax_group_sort
from torch_port_common import configs, t2n

torch.set_num_threads(2)

FIELDS = ("members", "member_valid", "assigned", "group_valid", "gt_length")


def _inputs(sb):
    return (np.asarray(sb.traj_position), np.asarray(sb.traj_valid).astype(bool),
            np.asarray(sb.agent_valid).astype(bool))


def _assert_equal(got, want):
    for name in FIELDS:
        a, b = t2n(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.astype(np.float64), b.astype(np.float64), err_msg=name)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(**MULTIGROUP)
    sb = multigroup_scenes(jcfg, num_scenes=4)
    tv = np.asarray(sb.traj_valid).copy()
    controlled = np.asarray(sb.moving & sb.agent_valid).copy()
    controlled[:, [0, 3, 15, 17]] = True  # both clusters, some agents of each
    lengths = tv.sum(axis=2)
    # scene 0: the longest-lived controlled vehicle is dead at t = 0
    e0_focal = int(np.argmax(np.where(controlled[0], lengths[0], -1)))
    tv[0, e0_focal, 0] = False
    # scene 1: a controlled vehicle with a length equal to another's
    tv[1, 3, 10:] = tv[1, 0, 10:]
    sb = dataclasses.replace(sb, traj_valid=tv)
    return jcfg, tcfg, sb, controlled


def test_scenes_have_ties_more_agents_than_the_crop_and_a_dead_focal(setup):
    jcfg, _, sb, controlled = setup
    lengths = np.asarray(sb.traj_valid).sum(axis=2)
    assert sb.traj_position.shape[1] > jcfg.waymo.max_num_agents
    for e in range(controlled.shape[0]):
        ev = lengths[e][controlled[e]]
        assert len(ev) > len(set(ev.tolist())), f"scene {e}: no tie of GT length"
    assert not np.asarray(sb.traj_valid)[0, :, 0][controlled[0]].all()


@pytest.mark.parametrize("crop", [None, 8])
def test_build_focal_groups_bit_equal_jax(setup, monkeypatch, crop):
    jcfg, tcfg, sb, controlled = setup
    stable_jax_group_sort(monkeypatch)
    want = jax_build_groups(jcfg, *_inputs(sb), controlled, crop_size=crop)
    got = build_focal_groups(tcfg, *_inputs(sb), controlled, crop_size=crop, device="cpu")
    assert want.members.shape[1] >= 2, "expected several groups a scene"
    _assert_equal(got, want)


def test_pad_groups_bit_equal_jax(setup, monkeypatch):
    jcfg, tcfg, sb, controlled = setup
    stable_jax_group_sort(monkeypatch)
    want = jax_build_groups(jcfg, *_inputs(sb), controlled, min_groups=2)
    got = build_focal_groups(tcfg, *_inputs(sb), controlled, min_groups=2, device="cpu")
    G = want.members.shape[1]
    _assert_equal(pad_groups(got, G + 2), jax_pad_groups(want, G + 2))
    _assert_equal(pad_groups(got, G), got)  # no padding asked for


def test_ties_go_to_the_higher_index_first():
    """The reference's rule (groups.py:100-103): with equal GT lengths the
    higher agent index is the first focal, so it owns the shared group."""
    _, tcfg = configs(**MULTIGROUP)
    E, A, T1 = 1, 4, 5
    pos = np.zeros((E, A, T1, 2), np.float32)
    pos[0, :, :, 0] = np.array([0.0, 5.0, 10.0, 300.0])[:, None]
    tv = np.ones((E, A, T1), bool)
    controlled = np.array([[True, True, False, False]])
    spec = build_focal_groups(tcfg, pos, tv, np.ones((E, A), bool), controlled, device="cpu")
    assert spec.num_groups == 1
    n = int(spec.member_valid[0, 0].sum())
    assert t2n(spec.members[0, 0, :n]).tolist() == [0, 1, 2]
    assert t2n(spec.assigned[0, 0, :n]).tolist() == [True, True, False]


def test_group_spec_lies_on_the_card_by_default(setup):
    _, tcfg, sb, controlled = setup
    if torch.cuda.is_available():
        assert build_focal_groups(tcfg, *_inputs(sb), controlled).members.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_focal_groups(tcfg, *_inputs(sb), controlled)


def _eval_scenes(jcfg):
    """Scenes of the default length (90 steps) from the JAX generator, with
    an 'interesting' pair made in every other scene: agent 1's goal moved
    next to agent 0's."""
    from ctrl_sim_tpu.data import synthetic_scenario as jax_synth

    out = []
    for s in range(6):
        sc = jax_synth(jcfg, seed=s, num_agents=10, arena_half=60.0, num_lanes=2)
        if s % 2 == 0:
            gp = sc.goal_position.copy()
            gp[1] = gp[0] + 3.0
            sc = dataclasses.replace(sc, goal_position=gp)
        out.append(sc)
    return out


@pytest.mark.parametrize("mode", ["multi_agent", "one_agent", "two_agent"])
def test_vehicle_selection_equals_jax(mode):
    over = {"eval.eval_mode": mode, "eval.multi_agent_eval_threshold": 3}
    from ctrl_sim_tpu.config import load_config as jax_load
    from ctrl_sim_tpu_torch.config import load_config as torch_load

    jcfg, tcfg = jax_load(over), torch_load(over)
    scenes = _eval_scenes(jcfg)
    jr, tr = random.Random(jcfg.eval.seed), random.Random(tcfg.eval.seed)
    picked = []
    for sc in scenes:
        want = jev.select_vehicles_to_evaluate(jcfg, sc, jr)
        got = tev.select_vehicles_to_evaluate(tcfg, sc, tr)
        assert got == want
        picked.append(got)
    assert any(picked), "no scene selected a vehicle"
    if mode == "multi_agent":
        assert any(len(p) == 3 for p in picked)  # random.sample over more movers than the threshold
    else:
        assert any(len(p) == (1 if mode == "one_agent" else 2) for p in picked)
        assert any(not p for p in picked)  # scenes without an interesting pair are dropped


def test_evaluator_chunks_select_and_group_as_jax(monkeypatch):
    """The evaluator's chunks: the controlled vehicles of each scene as the
    JAX evaluator's selection draws them, scenes without one dropped, and
    every chunk's groups padded to the largest count."""
    from ctrl_sim_tpu.config import load_config as jax_load
    from ctrl_sim_tpu_torch.config import load_config as torch_load
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim

    stable_jax_group_sort(monkeypatch)
    over = {"eval.eval_mode": "two_agent", "model.hidden_dim": 64, "model.num_heads": 4}
    jcfg, tcfg = jax_load(over), torch_load(over)
    scenes = _eval_scenes(jcfg)
    ev = tev.PolicyEvaluator(tcfg, CtRLSim(tcfg, device="cpu"), lane_batch=2, device="cpu")
    chunks = ev.chunks(scenes)
    rng = random.Random(jcfg.eval.seed)
    selected = [(s, v) for s in scenes if (v := jev.select_vehicles_to_evaluate(jcfg, s, rng))]
    assert len(chunks) == -(-len(selected) // 2)
    G = max(c[2].num_groups for c in chunks)
    for i, (batch, controlled, groups) in enumerate(chunks):
        part = selected[2 * i:2 * i + 2]
        assert [np.where(c)[0].tolist() for c in controlled] == [sorted(v) for _, v in part]
        want = jax_pad_groups(jax_build_groups(jcfg, *_inputs(batch), controlled), G)
        _assert_equal(groups, want)
