"""The port's training data path held against the JAX package at the toy
configuration of ``torch_port_common``, contacts off: the offline replay
(states, actions and rewards within 1e-4, existence exact), the RTG
computation and the training transforms within 1e-5, and ``build_train_batch``
with the JAX draws replayed (integer fields exact, float fields within
1e-5) and, without replay, in distribution.

The port computes what the JAX pipeline computes, including two of its
behaviours that ROADMAP §3 records as open questions: ``compute_rtgs`` sums
the returns over agents (axis 1 of the batch), and the train-time shuffle of
``select_relevant_agents_idx`` leaves the slots in distance order whatever
its key."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.data import transforms as jtf
from ctrl_sim_tpu.data.datagen import generate_offline_data as jax_replay
from ctrl_sim_tpu.data.pipeline import build_train_batch as jax_build_batch
from ctrl_sim_tpu.data.pipeline import compute_rtgs as jax_compute_rtgs
from ctrl_sim_tpu_torch.data import transforms as ttf
from ctrl_sim_tpu_torch.data.datagen import OfflineArrays, generate_offline_data
from ctrl_sim_tpu_torch.data.pipeline import TrainDraws, build_train_batch, compute_rtgs
from ctrl_sim_tpu_torch.data.store import ScenarioStore
from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario
from torch_port_common import configs, jax_scenario, scenes, t2n, torch_scenario

torch.set_num_threads(2)

E = 4
T = torch.as_tensor
INT_FIELDS = ("actions", "rtgs", "timesteps", "gather_idx", "slot_valid", "origin_idx")


@pytest.fixture(scope="module")
def replay():
    jcfg, tcfg = configs()
    sb = scenes(jcfg, E)
    js = jax_scenario(sb)
    joff = jax.jit(lambda s: jax_replay(jcfg, s))(js)
    toff = generate_offline_data(tcfg, torch_scenario(sb))
    return jcfg, tcfg, sb, js, jax.tree.map(np.asarray, joff), toff


def _per_scene_rtgs(cfg, off) -> np.ndarray:
    """The JAX transforms of dataset_ctrl_sim.py:93-105, one scene at a time."""
    def one(states, r8, ve, vv):
        r5 = jtf.compute_rewards5(states[..., -1], r8, ve, vv, cfg.waymo)
        return jtf.normalize_rtgs(jtf.select_rtg_components(jtf.reverse_cumsum_rtg(r5)), cfg.waymo)

    return np.asarray(jax.vmap(one)(off.states, off.rewards8, off.veh_edge_dist_rewards, off.veh_veh_dist_rewards))


def _jax_perms(keys, K) -> torch.Tensor:
    """The shuffle permutations the JAX ``build_train_sample`` draws from its keys."""
    return T(np.stack([np.asarray(jax.random.permutation(jax.random.split(k, 3)[2], K)) for k in keys]))


def test_offline_replay_matches_jax(replay):
    *_, joff, toff = replay
    np.testing.assert_array_equal(t2n(toff.states[..., -1]), joff.states[..., -1])
    for name in OfflineArrays._fields:
        np.testing.assert_allclose(t2n(getattr(toff, name)), getattr(joff, name), atol=1e-4, rtol=0, err_msg=name)


def test_compute_rtgs_matches_jax_per_scene(replay):
    """The batched ``compute_rtgs`` against the JAX pipeline's, and the
    port's one-scene transforms against the JAX ones applied per scene; the
    two differ in the axis of the cumulative sum (ROADMAP §3)."""
    jcfg, tcfg, *_, joff, toff = replay
    off = OfflineArrays(*(T(x) for x in joff))
    want = np.asarray(jax_compute_rtgs(jcfg, joff))
    np.testing.assert_allclose(t2n(compute_rtgs(tcfg, off)), want, atol=1e-5, rtol=0)
    per_scene = _per_scene_rtgs(jcfg, joff)

    def port_per_scene(states, r8, ve, vv):
        r5 = ttf.compute_rewards5(states[..., -1], r8, ve, vv, tcfg.waymo)
        return ttf.normalize_rtgs(ttf.select_rtg_components(ttf.reverse_cumsum_rtg(r5)), tcfg.waymo)

    got = port_per_scene(off.states, off.rewards8, off.veh_edge_dist_rewards, off.veh_veh_dist_rewards)
    np.testing.assert_allclose(t2n(got), per_scene, atol=1e-5, rtol=0)
    assert not np.allclose(want, per_scene, atol=1e-3)


@pytest.mark.parametrize("variant", [{}, {"waymo.remove_shaped_goal": False, "waymo.remove_shaped_veh_reward": True,
                                      "waymo.remove_shaped_edge_reward": True}])
def test_reward_and_rtg_transforms_match_jax(variant):
    jcfg, tcfg = configs(**variant)
    rng = np.random.default_rng(0)
    A, Tn = 6, 11
    pos = rng.normal(size=(E, A, Tn, 2)).astype(np.float32) * 8
    ex = (rng.random((E, A, Tn)) > 0.2).astype(np.float32)
    ex[0, 1:] = 0.0  # a scene with one existing agent
    r8 = rng.normal(size=(E, A, Tn, 8)).astype(np.float32)
    ve, vv = (rng.normal(size=(E, A, Tn)).astype(np.float32) for _ in range(2))
    for normalize in (True, False):
        want = jax.vmap(lambda p, e: jtf.compute_dist_to_nearest_vehicle_rewards(p, e, 15.0, normalize))(pos, ex)
        got = ttf.compute_dist_to_nearest_vehicle_rewards(T(pos), T(ex), 15.0, normalize)
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5, rtol=0)
    r5 = jax.vmap(lambda e, r, a, b: jtf.compute_rewards5(e, r, a, b, jcfg.waymo))(ex, r8, ve, vv)
    got5 = ttf.compute_rewards5(T(ex), T(r8), T(ve), T(vv), tcfg.waymo)
    np.testing.assert_allclose(t2n(got5), np.asarray(r5), atol=1e-5, rtol=0)
    rtg5 = jax.vmap(jtf.reverse_cumsum_rtg)(r5)
    np.testing.assert_allclose(t2n(ttf.reverse_cumsum_rtg(got5)), np.asarray(rtg5), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        t2n(ttf.normalize_rtgs(ttf.select_rtg_components(T(np.asarray(rtg5))), tcfg.waymo)),
        np.asarray(jtf.normalize_rtgs(jtf.select_rtg_components(rtg5), jcfg.waymo)), atol=1e-5, rtol=0)


def test_agent_selection_and_normalization_match_jax():
    jcfg, tcfg = configs(**{"waymo.max_num_road_polylines": 5})
    wc = jcfg.waymo
    rng = np.random.default_rng(1)
    A, K, Tn, P, L = 12, wc.max_num_agents, 6, 9, 4
    pos = (rng.normal(size=(E, A, 2)) * 40).astype(np.float32)
    valid = rng.random((E, A)) > 0.2
    origin = np.array([0, 3, 5, 11])
    valid[np.arange(E), origin] = True
    keep = rng.random((E, A)) > 0.1
    keep[np.arange(E), origin] = True
    for km in (None, keep):  # no shuffle; the sticky keep mask of evaluation
        want = jax.vmap(lambda x, v, o, k: jtf.select_relevant_agents_idx(x, v, o, wc, keep_mask=k))(
            pos, valid, origin, keep if km is None else km)
        if km is None:
            want = jax.vmap(lambda x, v, o: jtf.select_relevant_agents_idx(x, v, o, wc))(pos, valid, origin)
        got = ttf.select_relevant_agents_idx(T(pos), T(valid), T(origin), tcfg.waymo,
                                             keep_mask=None if km is None else T(km))
        for name in want._fields:
            np.testing.assert_array_equal(t2n(getattr(got, name)), np.asarray(getattr(want, name)))
    # the JAX shuffle replayed with its own permutations, and a random
    # permutation: both leave the distance order as it is
    keys = jax.random.split(jax.random.PRNGKey(7), E)
    want = jax.vmap(lambda x, v, o, k: jtf.select_relevant_agents_idx(x, v, o, wc, shuffle_key=k))(
        pos, valid, origin, keys)
    unshuffled = jax.vmap(lambda x, v, o: jtf.select_relevant_agents_idx(x, v, o, wc))(pos, valid, origin)
    perms = T(np.stack([np.asarray(jax.random.permutation(k, K)) for k in keys]))
    assert not torch.equal(perms, torch.arange(K).expand(E, K))
    got = ttf.select_relevant_agents_idx(T(pos), T(valid), T(origin), tcfg.waymo, perm=perms)
    shuffled = ttf.select_relevant_agents_idx(T(pos), T(valid), T(origin), tcfg.waymo,
                                              perm=T(np.stack([rng.permutation(K) for _ in range(E)])))
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, name)), np.asarray(getattr(unshuffled, name)))
        np.testing.assert_array_equal(t2n(getattr(got, name)), np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(t2n(getattr(shuffled, name)), np.asarray(getattr(want, name)))
    states = rng.normal(size=(E, A, Tn, 8)).astype(np.float32)
    np.testing.assert_allclose(
        t2n(ttf.gather_agents(T(states), got)),
        np.asarray(jax.vmap(jtf.gather_agents)(states, want)), atol=0, rtol=0)

    sel = states[:, :K] * 10
    goals = rng.normal(size=(E, K, 5)).astype(np.float32) * 10
    rp = rng.normal(size=(E, P, L, 3)).astype(np.float32) * 30
    rp[..., 2] = rng.random((E, P, L)) > 0.3
    rt = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (E, P))]
    rv = rng.random((E, P)) > 0.2
    o = np.array([0, 2, 4, 1])
    anchor = rng.normal(size=(E, 3)).astype(np.float32)
    for a in (None, anchor):
        want = jax.vmap(lambda s, p, t, v, g, oi, an: jtf.normalize_scene(s, p, t, v, g, oi, wc, anchor_pose=an),
                        in_axes=(0, 0, 0, 0, 0, 0, None if a is None else 0))(sel, rp, rt, rv, goals, o, a)
        got = ttf.normalize_scene(T(sel), T(rp), T(rt), T(rv), T(goals), T(o), tcfg.waymo,
                                  anchor_pose=None if a is None else T(a))
        for name in want._fields:
            np.testing.assert_allclose(t2n(getattr(got, name)), np.asarray(getattr(want, name)),
                                       atol=1e-5, rtol=1e-6, err_msg=name)


def _jax_draws(key, jb):
    """The draws of the JAX ``build_train_batch`` from ``key``: the window
    starts and origin agents read back from its batch, and the shuffle
    permutations drawn again from its keys."""
    K = jb["gather_idx"].shape[1]
    gi, oi = np.asarray(jb["gather_idx"]), np.asarray(jb["origin_idx"])
    perm = _jax_perms(jax.random.split(key, E), K)
    return TrainDraws(T(np.asarray(jb["timesteps"])[:, 0]), T(gi[np.arange(E), oi]), perm)


@pytest.mark.parametrize("episode_start", [False, True])
def test_build_train_batch_replays_jax_draws(replay, episode_start):
    over = {"waymo.episode_start_normalization": episode_start}
    jcfg, tcfg = configs(**over)
    _, _, sb, js, joff, _ = replay
    key = jax.random.PRNGKey(3)
    jb = jax_build_batch(jcfg, key, js, joff)
    got = build_train_batch(tcfg, torch_scenario(sb), OfflineArrays(*(T(x) for x in joff)),
                            draws=_jax_draws(key, jb))
    assert got.keys() == jb.keys()
    for k in jb:
        # rtol 1e-6 for the -1e6 sentinel of dead agents, whose rotated
        # coordinates are ~1e6 (an fp32 ulp there is 0.06)
        kw = {"atol": 0, "rtol": 0} if k in INT_FIELDS else {"atol": 1e-5, "rtol": 1e-6}
        np.testing.assert_allclose(t2n(got[k]).astype(np.float64), np.asarray(jb[k]).astype(np.float64),
                                   err_msg=k, **kw)


def _same_mean(a: np.ndarray, b: np.ndarray) -> bool:
    """Two samples' means within 5 standard errors of their difference."""
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    return abs(a.mean() - b.mean()) <= 5 * se + 1e-9


def test_build_train_batch_draws_in_distribution(replay):
    """Without replay, the port's own draws over many copies of the same
    scenes: per scene, the window start and the origin agent agree with the
    JAX draws in mean, and the origin lands in slot 0 as in the JAX batch
    (the nearest agent to itself; the shuffle keeps the distance order)."""
    jcfg, tcfg, sb, _, joff, _ = replay
    reps = 256
    idx = np.repeat(np.arange(E), reps)
    big = dataclasses.replace(sb, **{f.name: getattr(sb, f.name)[idx] for f in dataclasses.fields(sb)
                                     if isinstance(getattr(sb, f.name), np.ndarray)})
    off = jax.tree.map(lambda x: x[idx], joff)
    jb = jax.jit(lambda k, s, o: jax_build_batch(jcfg, k, s, o))(jax.random.PRNGKey(0), jax_scenario(big), off)
    tb = build_train_batch(tcfg, torch_scenario(big), OfflineArrays(*(T(x) for x in off)),
                           generator=torch.Generator().manual_seed(0))

    def draws(b):
        b = {k: t2n(v) if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in b.items()}
        agent = b["gather_idx"][np.arange(E * reps), b["origin_idx"]]
        return [x.reshape(E, reps).astype(np.float64)
                for x in (b["timesteps"][:, 0], agent, b["origin_idx"], b["slot_valid"].sum(-1))]

    (jt, ja, jslot, _), (tt, ta, tslot, tvalid) = draws(jb), draws(tb)
    assert (jslot == 0).all()
    for s in range(E):
        for name, j, t in (("window start", jt[s], tt[s]), ("origin agent", ja[s], ta[s])):
            assert _same_mean(j, t), (name, s, j.mean(), t.mean())
            assert set(np.unique(t)) <= set(range(int(j.max()) + 1)) | set(np.unique(j)), (name, s)
    assert (tslot == 0).all()
    assert (tvalid >= 1).all()


def test_store_round_trip_and_sampling(tmp_path):
    _, tcfg = configs()
    scenes_np = [synthetic_scenario(tcfg, seed=s, num_agents=8, arena_half=60.0, num_lanes=2) for s in range(3)]
    store = ScenarioStore.from_scenes(tcfg, scenes_np, replay_chunk=2, device="cpu")
    assert store.num_scenes == 3
    store.save(str(tmp_path))
    again = ScenarioStore.load(tcfg, str(tmp_path), device="cpu")
    for a, b in zip(store.offline, again.offline):
        assert torch.equal(a, b)
    b1 = store.sample_batch(torch.Generator().manual_seed(4), 5)
    b2 = again.sample_batch(torch.Generator().manual_seed(4), 5)
    assert b1.keys() == b2.keys()
    for k in b1:
        assert torch.equal(b1[k], b2[k]), k
    assert b1["agent_states"].shape[:3] == (5, tcfg.waymo.max_num_agents, tcfg.waymo.train_context_length)
    with pytest.raises(NotImplementedError):
        store.sample_batch(None, 2, family="ctg_plus_plus")
    with pytest.raises(FileNotFoundError):  # the loaders are ported: a directory without scene JSONs
        ScenarioStore.from_json_dir(tcfg, str(tmp_path))
