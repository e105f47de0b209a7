"""The port's CTG++ data path (``data/ctg_pipeline.py``) held against the
JAX package at the CTG++ toy config, contacts off: the per-agent frames,
the relative encodings and the road crops on random inputs (float fields
within 1e-5 absolute / 1e-4 relative, masks, indices and types bit for
bit), and ``build_ctg_batch`` on the same offline arrays with the JAX
draws replayed (integer fields exact), in training and in evaluation;
without replay, its own draws are held to the pipeline's rules, and
``ScenarioStore.sample_batch(family="ctg_plus_plus")`` serves them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.data import ctg_pipeline as jcp
from ctrl_sim_tpu.data.datagen import generate_offline_data as jax_replay
from ctrl_sim_tpu_torch.data import ctg_pipeline as tcp
from ctrl_sim_tpu_torch.data.datagen import OfflineArrays
from ctrl_sim_tpu_torch.data.pipeline import TrainDraws
from ctrl_sim_tpu_torch.data.store import ScenarioStore
from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario
from torch_port_common import ctg_configs, jax_scenario, scenes, t2n, torch_scenario

torch.set_num_threads(2)

E, A, T_STEPS = 3, 6, 5
T = torch.as_tensor
TOL = {"atol": 1e-5, "rtol": 1e-4}
INT_FIELDS = ("rtgs", "timesteps", "gather_idx", "slot_valid", "origin_idx", "agent_types")
CFG = {"sim.steps": 16, "sim.resolve_contacts": False, "sim.max_agents": 6}


def _states(rng, shape) -> np.ndarray:
    s = rng.normal(size=shape + (8,)).astype(np.float32) * 10
    s[..., 4] = rng.uniform(-np.pi, np.pi, size=shape)
    s[..., -1] = rng.random(shape) > 0.2
    return s


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    states = _states(rng, (E, A, T_STEPS))
    anchor = states[:, :, -1].copy()
    anchor[0, 1, -1] = 0.0  # an agent missing at its anchor
    goals = rng.normal(size=(E, A, 5)).astype(np.float32) * 10
    roads = rng.normal(size=(E, A, 4, 6, 3)).astype(np.float32) * 20
    roads[..., -1] = rng.random((E, A, 4, 6)) > 0.3
    return states, anchor, goals, roads


def test_local_frames_match_jax(inputs):
    states, anchor, goals, roads = inputs
    checks = (
        (jcp.agents_local_frame, tcp.agents_local_frame, states),
        (jcp.roads_local_frame, tcp.roads_local_frame, roads),
        (jcp.goals_local_frame, tcp.goals_local_frame, goals),
    )
    for jfn, tfn, x in checks:
        want = jax.jit(jax.vmap(jfn))(x, anchor)
        np.testing.assert_allclose(t2n(tfn(T(x), T(anchor))), np.asarray(want), err_msg=tfn.__name__, **TOL)


def test_relative_encodings_match_jax(inputs):
    states, anchor, _, _ = inputs
    s13 = jax.vmap(jcp.agents_local_frame)(states, anchor)
    want = jax.jit(jax.vmap(jcp.relative_encodings))(s13, s13[:, :, -1])
    got = tcp.relative_encodings(T(np.asarray(s13)), T(np.asarray(s13[:, :, -1])))
    assert got.shape == (E, A, A, T_STEPS, 7)
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("cap", [3, 8], ids=["sorted", "padded"])
def test_select_agent_roads_matches_jax(cap):
    """Both branches: more polylines than the cap (the stable sort by each
    polyline's farthest valid point, with polylines of no valid point and
    invalid polylines at +inf and ties among them kept in order) and fewer
    (order kept, padded with zero points and -1 types); agents missing at
    the anchor zeroed."""
    rng = np.random.default_rng(1)
    P, L = 6, 5
    rp = rng.normal(size=(E, P, L, 3)).astype(np.float32) * 20
    rp[..., -1] = rng.random((E, P, L)) > 0.3
    rp[:, 1, :, -1] = 0.0  # no valid point: -inf distance, moved to +inf
    rp[:, 4] = rp[:, 2]  # a tie
    rt = np.eye(8, dtype=np.float32)[rng.integers(0, 8, size=(E, P))]
    rv = rng.random((E, P)) > 0.2
    pos = rng.normal(size=(E, A, 2)).astype(np.float32) * 20
    exist = (rng.random((E, A)) > 0.2).astype(np.float32)
    want = jax.jit(jax.vmap(lambda *a: jcp.select_agent_roads(*a, cap)))(pos, exist, rp, rt, rv)
    got = tcp.select_agent_roads(T(pos), T(exist), T(rp), T(rt), T(rv), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(t2n(g), np.asarray(w))


def test_action_normalization_round_trip_matches_jax():
    from ctrl_sim_tpu.rollout.ctg_rollout import _unnormalize_actions

    _, tcfg = ctg_configs()
    a = np.random.default_rng(2).uniform(-1.5, 1.5, size=(4, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(t2n(tcp.unnormalize_actions(T(a), tcfg.waymo)),
                               np.asarray(_unnormalize_actions(jnp.asarray(a), tcfg.waymo)), **TOL)
    back = tcp.normalize_actions(tcp.unnormalize_actions(T(a), tcfg.waymo), tcfg.waymo)
    np.testing.assert_allclose(t2n(back), np.clip(a, -1, 1), atol=1e-5)


@pytest.fixture(scope="module")
def replay():
    jcfg, tcfg = ctg_configs(**CFG)
    sb = scenes(jcfg, 4, num_agents=5)
    joff = jax.tree.map(np.asarray, jax.jit(lambda s: jax_replay(jcfg, s))(jax_scenario(sb)))
    return jcfg, tcfg, sb, joff


def _jax_draws(jcfg, key, jb, n: int) -> TrainDraws:
    """The draws of the JAX ``build_ctg_batch`` from ``key``: window starts
    and origin agents read back from its batch, the shuffle permutations
    drawn again from its keys."""
    K, T_in = jcfg.waymo.max_num_agents, jcfg.waymo.input_horizon
    gi, oi = np.asarray(jb["gather_idx"]), np.asarray(jb["origin_idx"])
    perm = np.stack([np.asarray(jax.random.permutation(jax.random.split(k, 3)[2], K))
                     for k in jax.random.split(key, n)])
    return TrainDraws(T(np.asarray(jb["timesteps"])[:, 0] - (T_in - 1)), T(gi[np.arange(n), oi]), T(perm))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_build_ctg_batch_replays_jax_draws(replay, train):
    jcfg, tcfg, sb, joff = replay
    key = jax.random.PRNGKey(3)
    jb = jax.jit(lambda k, s, o: jcp.build_ctg_batch(jcfg, k, s, o, train=train))(
        key, jax_scenario(sb), joff)
    n = joff.states.shape[0]
    got = tcp.build_ctg_batch(tcfg, torch_scenario(sb), OfflineArrays(*(T(x) for x in joff)),
                              draws=_jax_draws(jcfg, key, jb, n), train=train)
    assert got.keys() == jb.keys()
    for k in jb:
        # rtol 1e-6 for the -1e6 sentinel of dead agents
        kw = {"atol": 0, "rtol": 0} if k in INT_FIELDS else {"atol": 1e-5, "rtol": 1e-5}
        np.testing.assert_allclose(t2n(got[k]).astype(np.float64), np.asarray(jb[k]).astype(np.float64),
                                   err_msg=k, **kw)


def test_store_serves_ctg_batches_from_its_own_draws(replay):
    """``sample_batch(family="ctg_plus_plus")`` on the port's own draws: the
    JAX batch's keys and shapes, seeded, every window inside the episode's
    moving span and every origin agent a moving agent present at the
    window's present step."""
    _, tcfg, _, _ = replay
    scenes_np = [synthetic_scenario(tcfg, seed=s, num_agents=5, arena_half=60.0, num_lanes=2) for s in range(3)]
    store = ScenarioStore.from_scenes(tcfg, scenes_np, device="cpu")
    b1 = store.sample_batch(torch.Generator().manual_seed(4), 16, family="ctg_plus_plus")
    b2 = store.sample_batch(torch.Generator().manual_seed(4), 16, family="ctg_plus_plus")
    wc = tcfg.waymo
    K, T_in, T_out = wc.max_num_agents, wc.input_horizon, wc.train_context_length - wc.input_horizon
    shapes = {"agent_past_states": (16, K, T_in, 8), "agent_future_states": (16, K, T_out, 6),
              "agent_past_actions": (16, K, T_in, 2), "past_relative_encodings": (16, K, K, T_in, 7),
              "future_relative_encodings": (16, K, K, T_out, 7), "rtgs": (16, K, T_in, 3),
              "road_points": (16, K, wc.max_num_road_polylines, wc.max_num_road_pts_per_polyline, 3)}
    for k, shape in shapes.items():
        assert tuple(b1[k].shape) == shape, k
    for k in b1:
        assert torch.equal(b1[k], b2[k]), k
        assert torch.isfinite(b1[k].float()).all(), k
    # the origin sits at its own frame's origin at the present step
    origin = b1["origin_idx"]
    past = b1["agent_past_states"][torch.arange(16), origin]
    assert (past[:, -1, -1] > 0).all() and b1["moving_agent_mask"][torch.arange(16), origin].eq(1).all()
    assert past[:, -1, :2].abs().max() < 1e-5
    assert (b1["agent_past_actions"].abs() <= 1.0 + 1e-6).all()
    with pytest.raises(ValueError):
        store.sample_batch(None, 2, family="no_such_family")
