"""The port's evaluators and their host-side helpers held against the JAX
package at the toy config of ``torch_port_common``:

- ``PolicyMetricsAccumulator`` / ``jsd_suite`` on identical streams within
  1e-6, and the metrics pooled over two chunks equal to one chunk of both;
- ``PolicyEvaluator.evaluate`` (exact and streaming) and
  ``PlannerAdversaryEvaluator.evaluate`` end to end, the port's rollouts
  under the JAX rollouts' replayed draws: rates exact, ADE / FDE within
  1e-3, the rest within 1e-3 (JSDs: a speed within 1e-3 of a bin edge may
  change bins; none did at these seeds);
- the normalization guards raise where the JAX ones raise;
- ``cat.make_adversarial_scenario`` and the polyline helpers within 1e-6;
- ``FinetuningStore`` batches from the JAX store's indices and draws equal
  to the JAX batches;
- ``export_physics_json`` equal to the JAX file key for key;
- one ``eval_sim`` and one ``eval_planner`` CLI call on the CPU, the first
  restoring a checkpoint of the port's trainer."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.data import synthetic_scenario as jax_synth
from ctrl_sim_tpu.evals import cat as jcat, evaluator as jev, metrics as jmet
from ctrl_sim_tpu.evals.planner_adversary import PlannerAdversaryEvaluator as JaxPlannerEvaluator
from ctrl_sim_tpu.rollout import rollout as jax_rollout, streaming as jax_streaming
from ctrl_sim_tpu.rollout.rollout import RolloutOutput as JaxRolloutOutput
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.evals import cat as tcat, evaluator as tev, metrics as tmet
from ctrl_sim_tpu_torch.evals.planner_adversary import PlannerAdversaryEvaluator
from ctrl_sim_tpu_torch.rollout.rollout import RolloutOutput
from torch_closed_loop_common import record_jax_draws, split_replays, stable_jax_group_sort
from torch_port_common import TOY, configs, family_configs, models

torch.set_num_threads(2)

RATES = ("goal", "collision_rate", "offroad_rate")
INT_FIELDS = ("actions", "rtgs", "timesteps", "gather_idx", "slot_valid", "origin_idx")


def _port_scene(sc) -> Scenario:
    """A JAX numpy scene as the port's numpy scene."""
    fields = {f.name for f in dataclasses.fields(Scenario)}
    return Scenario(**{k: v for k, v in dataclasses.asdict(sc).items() if k in fields})


def _scene_list(cfg, n: int, num_agents: int = 8, seed0: int = 0) -> list:
    return [jax_synth(cfg, seed=seed0 + s, num_agents=num_agents, arena_half=60.0, num_lanes=2) for s in range(n)]


# ---------------------------------------------------------------- metrics


def _random_streams(cfg, E: int, A: int, seed: int):
    """Rollout-shaped numpy streams [T(+1), E, A, ...] with some dead steps,
    goals, collisions and offroad events, and a scene batch whose GT
    trajectories lie near them."""
    rng = np.random.default_rng(seed)
    T = cfg.sim.steps
    pos = np.cumsum(rng.normal(size=(T + 1, E, A, 2)), axis=0).astype(np.float32)
    exist = (rng.random((T + 1, E, A)) > 0.1).astype(np.float32)
    reward8 = np.zeros((T + 1, E, A, 8), np.float32)
    for c, p in ((0, 0.05), (6, 0.03), (7, 0.03)):
        reward8[..., c] = rng.random((T + 1, E, A)) < p
    ro = dict(
        position=pos,
        velocity=rng.normal(size=(T + 1, E, A, 2)).astype(np.float32) * 5,
        heading=rng.uniform(-3, 3, size=(T + 1, E, A)).astype(np.float32),
        speed=rng.uniform(0, 20, size=(T + 1, E, A)).astype(np.float32),
        existence=exist,
        reward8=reward8,
        acceleration=rng.uniform(-10, 10, size=(T, E, A)).astype(np.float32),
        steering=rng.uniform(-0.7, 0.7, size=(T, E, A)).astype(np.float32),
        nearest_dist=rng.uniform(0, 50, size=(T + 1, E, A)).astype(np.float32),
        rtgs=np.zeros((T, E, A, 3), np.float32),
        controlled_mask=rng.random((E, A)) > 0.4,
    )
    gt = np.transpose(pos, (1, 2, 0, 3)) + rng.normal(size=(E, A, T + 1, 2)).astype(np.float32)
    scene = dict(traj_position=gt, traj_heading=rng.uniform(-3, 3, size=(E, A, T + 1)).astype(np.float32),
                 traj_speed=rng.uniform(0, 20, size=(E, A, T + 1)).astype(np.float32))
    return ro, scene


class _GT:
    """The GT fields the accumulators read."""

    def __init__(self, d):
        self.__dict__.update(d)


def test_metrics_equal_jax_on_identical_streams_and_pool_over_chunks():
    jcfg, tcfg = configs()
    ro, scene = _random_streams(tcfg, E=6, A=7, seed=0)
    want_acc = jmet.PolicyMetricsAccumulator(jcfg)
    want_acc.update(JaxRolloutOutput(**ro), _GT(scene))
    want = want_acc.compute()
    got = tmet.compute_policy_metrics(tcfg, RolloutOutput(**{k: torch.as_tensor(v) for k, v in ro.items()}),
                                      _GT(scene))
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert 0 < want["goal"] < 1 and 0 < want["collision_rate"] < 1 and 0 < want["ade"]
    # the same scenes as two chunks of 2 and 4: the pooled streams, so the same metrics
    pooled = tmet.PolicyMetricsAccumulator(tcfg)
    for lo, hi in ((0, 2), (2, 6)):
        part = {k: (v[:, lo:hi] if k != "controlled_mask" else v[lo:hi]) for k, v in ro.items()}
        pooled.update(RolloutOutput(**part), _GT({k: v[lo:hi] for k, v in scene.items()}))
    for k, v in pooled.compute().items():
        assert abs(v - want[k]) <= 1e-12, (k, v, want[k])


def test_jsd_suite_and_jsd_equal_jax():
    jcfg, tcfg = configs()
    rng = np.random.default_rng(1)
    streams = [[rng.normal(loc=m, scale=s, size=n) for n in (50, 70)]
               for m, s in ((8, 4), (9, 5), (0, 10), (1, 12), (0, 4), (0.5, 3), (12, 6), (14, 7))]
    want = jmet.jsd_suite(jcfg, *streams, prefix="adv_")
    got = tmet.jsd_suite(tcfg, *streams, prefix="adv_")
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
        assert 0 <= got[k] <= np.sqrt(np.log(2)) + 1e-12
    p, q = rng.random(30), rng.random(30)
    assert abs(tmet._jsd(p, q) - jmet._jsd(p, q)) <= 1e-12
    pos = rng.normal(size=(3, 5, 9, 2)) * 20
    ex = (rng.random((3, 5, 9)) > 0.3).astype(np.float64)
    np.testing.assert_allclose(tmet.gt_nearest_dist_stream(pos, ex), jmet.gt_nearest_dist_stream(pos, ex),
                               atol=1e-6)


# ------------------------------------------------------ evaluators end to end


def _assert_metrics_match(got: dict, want: dict, rates=RATES) -> None:
    assert got.keys() == want.keys() and want
    for k in want:
        if k in rates:
            assert got[k] == want[k], (k, got[k], want[k])
        else:
            assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
        assert np.isfinite(got[k])


@pytest.mark.parametrize("mode", ["exact", "streaming"])
def test_policy_evaluator_matches_jax_under_replayed_draws(mode, monkeypatch):
    stable_jax_group_sort(monkeypatch)
    over = {"eval.agent_slots": 0, "eval.rollout_mode": mode, "eval.multi_agent_eval_threshold": 3}
    if mode == "streaming":
        over.update({"waymo.episode_start_normalization": True, "eval.agent_slots": 8})
    jcfg, tcfg = family_configs("ctrl_sim", **over)
    jm, params, tm = models(jcfg, tcfg)
    jscenes = _scene_list(jcfg, 5)
    module = jax_rollout if mode == "exact" else jax_streaming
    with record_jax_draws(module) as rec:
        want = jev.PolicyEvaluator(jcfg, jm, params, lane_batch=2).evaluate(jscenes)
    ev = tev.PolicyEvaluator(tcfg, tm, lane_batch=2, device="cpu")
    chunks = ev.chunks([_port_scene(s) for s in jscenes])
    assert len(chunks) == 3
    got = ev.evaluate([_port_scene(s) for s in jscenes],
                      samplers=split_replays(rec, tcfg.sim.steps, True, len(chunks)))
    _assert_metrics_match(got, want)
    assert want["ade"] > 0


def test_planner_adversary_evaluator_matches_jax_under_replayed_draws():
    """Explicit (ego, adversary) pairs over 3 scenes in chunks of 2; the
    adversary of scene 1 replays a CAT trajectory (an uncontrolled
    log-replay agent), the others run the negatively tilted policy."""
    jcfg, tcfg = family_configs("ctrl_sim", **{"eval.agent_slots": 0})
    jm, params, tm = models(jcfg, tcfg)
    jscenes = _scene_list(jcfg, 3, seed0=10)
    pairs = [(0, 1), (2, 3), (1, 0)]
    T1 = jscenes[1].traj_position.shape[1]
    ego0 = jscenes[1].traj_position[2, 0]
    attack = ego0[None] + np.linspace(0.0, 1.0, T1)[:, None] * (jscenes[1].traj_position[2, -1] - ego0)[None]
    advs = [None, attack.astype(np.float32), None]
    with record_jax_draws(jax_rollout) as rec:
        want = JaxPlannerEvaluator(jcfg, jm, params, lane_batch=2).evaluate(jscenes, pairs, advs)
    got = PlannerAdversaryEvaluator(tcfg, tm, lane_batch=2, device="cpu").evaluate(
        [_port_scene(s) for s in jscenes], pairs, advs, samplers=split_replays(rec, tcfg.sim.steps, True, 2))
    _assert_metrics_match(got, want, rates=("ego_goal", "ego_cr", "ego_cr_w_adv", "ego_or"))
    assert want["ego_ade"] > 0


def test_evaluators_refuse_the_card_they_lack_and_ctg():
    _, tcfg = family_configs("ctrl_sim", **{"eval.agent_slots": 0})
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim

    model = CtRLSim(tcfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tev.PolicyEvaluator(tcfg, model)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PlannerAdversaryEvaluator(tcfg, model)
    # the CTG++ closed-loop policy, refused until it was ported, is the
    # evaluator's CTG++ branch: no tilt, no focal groups
    # (tests/test_torch_ctg_eval.py runs it)
    from ctrl_sim_tpu_torch.training import CTGTrainer
    from torch_port_common import ctg_configs

    _, ctg = ctg_configs()
    ctg_model = CTGTrainer(ctg, device="cpu").init_state(torch.Generator().manual_seed(0)).model
    ev = tev.PolicyEvaluator(ctg, ctg_model, device="cpu")
    assert ev._rollout is tev.rollout_fn(ctg) is not tev.rollout_fn(tcfg)
    scenes = [_port_scene(jax_synth(ctg, seed=0, num_agents=4))]
    assert [groups for _, _, groups in ev.chunks(scenes)] == [None]


# ------------------------------------------------------------------ guards


@pytest.mark.parametrize("mode,esn,allow", [
    ("streaming", False, False), ("streaming", True, False), ("streaming", False, True), ("exact", False, False),
])
def test_streaming_normalization_guard_raises_as_jax(mode, esn, allow):
    jcfg, tcfg = configs(**{"eval.rollout_mode": mode, "waymo.episode_start_normalization": esn,
                            "eval.allow_normalization_mismatch": allow})
    raised = []
    for fn, cfg in ((jev.check_streaming_normalization, jcfg), (tev.check_streaming_normalization, tcfg)):
        try:
            fn(cfg)
            raised.append(None)
        except ValueError as e:
            raised.append(str(e))
    assert raised[0] == raised[1]
    assert (raised[0] is not None) == (mode == "streaming" and not esn and not allow)


@pytest.mark.parametrize("trained_esn", [False, True, None])
def test_checkpoint_normalization_guard_raises_as_jax(tmp_path, capsys, trained_esn):
    """A checkpoint directory whose config.json snapshot disagrees with
    the eval config's frame is refused by both; one without a snapshot
    only warns."""
    if trained_esn is not None:
        (tmp_path / "config.json").write_text(json.dumps({"waymo": {"episode_start_normalization": trained_esn}}))
    jcfg, tcfg = configs()
    outcomes = []
    for fn, cfg in ((jev.check_checkpoint_normalization, jcfg), (tev.check_checkpoint_normalization, tcfg)):
        try:
            fn(cfg, str(tmp_path))
            outcomes.append(None)
        except SystemExit as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is not None) == (trained_esn is True)
    if trained_esn is None:
        assert capsys.readouterr().out.count("no config.json snapshot") == 2


# --------------------------------------------------------------------- CAT


def test_cat_scenario_and_polyline_helpers_equal_jax():
    jcfg, _ = configs()
    sc = jax_synth(jcfg, seed=3, num_agents=8, arena_half=60.0, num_lanes=2)
    rng = np.random.default_rng(2)
    attack = np.cumsum(rng.normal(size=(sc.traj_position.shape[1] - 5, 2)), axis=0) + sc.traj_position[4, 0]
    attack[10:13] = attack[9]  # a stop: polyline yaw of zero-length segments
    want, wi = jcat.make_adversarial_scenario(sc, 4, attack)
    got, gi = tcat.make_adversarial_scenario(_port_scene(sc), 4, attack)
    assert gi == wi == 4 and got.name == want.name
    for f in dataclasses.fields(Scenario):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=1e-6,
                                       err_msg=f.name)
    np.testing.assert_allclose(tcat.polyline_yaw(attack), jcat.polyline_yaw(attack), atol=1e-6)
    np.testing.assert_allclose(tcat.polyline_vel(attack), jcat.polyline_vel(attack), atol=1e-6)
    pos0 = sc.traj_position[:, 0]
    for sdc, adv in ((pos0[1], pos0[5]), (pos0[1] + 0.5, pos0[5]), (np.zeros(2), pos0[5])):
        assert tcat.match_adversary_by_position(_port_scene(sc), sdc, adv) == \
            jcat.match_adversary_by_position(sc, sdc, adv)


# ------------------------------------------------------- finetuning, export


@pytest.fixture(scope="module")
def stores():
    """JAX stores of real and CAT scenes, and the port's over the JAX
    store's replayed arrays (the replay itself is held to JAX's in
    tests/test_torch_data.py)."""
    from ctrl_sim_tpu.data.finetune import FinetuningStore as JaxFinetuningStore
    from ctrl_sim_tpu.data.store import ScenarioStore as JaxStore
    from ctrl_sim_tpu_torch.data.finetune import FinetuningStore
    from ctrl_sim_tpu_torch.data.store import ScenarioStore

    jcfg, tcfg = configs()
    real = _scene_list(jcfg, 3)
    cat, focal = [], []
    for s, base in enumerate(_scene_list(jcfg, 3, seed0=20)):
        a = 1 + s
        attack = base.traj_position[a] + np.linspace(0, 5, base.traj_position.shape[1])[:, None]
        cat.append(jcat.make_adversarial_scenario(base, a, attack)[0])
        focal.append(a)
    jreal, jsim = JaxStore.from_scenes(jcfg, real), JaxStore.from_scenes(jcfg, cat)

    def port(store):
        return ScenarioStore(tcfg, _port_scene(store.scenario), jax.tree.map(np.asarray, store.offline),
                             device="cpu")

    return (jcfg, tcfg, JaxFinetuningStore(jcfg, jreal, jsim, np.array(focal)),
            FinetuningStore(tcfg, port(jreal), port(jsim), focal))


@pytest.mark.parametrize("supervise", [True, False])
def test_finetuning_batches_equal_jax(stores, supervise):
    from ctrl_sim_tpu_torch.data.pipeline import TrainDraws

    jcfg, tcfg, jstore, tstore = stores
    jstore.cfg = dataclasses.replace(jcfg, waymo=dataclasses.replace(jcfg.waymo, supervise_focal_agent=supervise))
    tstore.cfg = dataclasses.replace(tcfg, waymo=dataclasses.replace(tcfg.waymo, supervise_focal_agent=supervise))
    B, key = 6, jax.random.PRNGKey(5)
    jb = jax.tree.map(np.array, jstore.sample_batch(key, B))
    _, k_real, k_sim, k_batch = jax.random.split(key, 4)
    idx = (np.array(jax.random.randint(k_real, (3,), 0, 3)), np.array(jax.random.randint(k_sim, (3,), 0, 3)))
    gi, oi = jb["gather_idx"], jb["origin_idx"]
    # the JAX draws: window starts and origins read back, the shuffles drawn again from its keys
    perms = [np.asarray(jax.random.permutation(jax.random.split(k, 3)[2], gi.shape[1]))
             for k in jax.random.split(k_batch, B)]
    draws = TrainDraws(torch.as_tensor(jb["timesteps"][:, 0]), torch.as_tensor(gi[np.arange(B), oi]),
                       torch.as_tensor(np.stack(perms)))
    got = tstore.sample_batch(None, B, indices=idx, draws=draws)
    assert got.keys() == jb.keys()
    for k in jb:
        kw = {"atol": 0, "rtol": 0} if k in INT_FIELDS else {"atol": 1e-5, "rtol": 1e-6}
        np.testing.assert_allclose(got[k].numpy().astype(np.float64), jb[k].astype(np.float64), err_msg=k, **kw)
    # the CAT half is centered on its focal agent, and supervised alone where asked
    focal = np.array([1, 2, 3])[idx[1]]
    np.testing.assert_array_equal(gi[np.arange(3, 6), oi[3:]], focal)
    assert (jb["moving_agent_mask"][3:].sum(axis=1) == 1).all() == supervise


def test_export_physics_json_equal_jax(stores, tmp_path):
    from ctrl_sim_tpu.data.export import export_physics_json as jax_export
    from ctrl_sim_tpu_torch.data.export import export_physics_json

    jcfg, tcfg, jstore, tstore = stores
    off = jax.tree.map(np.asarray, jstore.real.offline)
    for e in range(2):
        jax_export(jcfg, jstore.real.scenario, off, e, str(tmp_path / f"jax_{e}.json"))
        export_physics_json(tcfg, tstore.real.scenario, tstore.real.offline, e, str(tmp_path / f"port_{e}.json"))
        want = json.loads((tmp_path / f"jax_{e}.json").read_text())
        got = json.loads((tmp_path / f"port_{e}.json").read_text())
        assert got.pop("name") == f"port_{e}.json" and want.pop("name") == f"jax_{e}.json"
        assert got == want
        assert want["objects"] and want["roads"]


def test_split_and_filter_equal_jax(tmp_path):
    from ctrl_sim_tpu.data import export as jexp
    from ctrl_sim_tpu_torch.data import export as texp

    names = [f"scene_{i:04d}.json" for i in range(40)]
    assert texp.split_val_test(names, num_test=15) == jexp.split_val_test(names, num_test=15)
    texp.write_test_filenames(names[:3], str(tmp_path / "t.json"))
    jexp.write_test_filenames(names[:3], str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    jcfg, _ = configs()
    scenes = _scene_list(jcfg, 4)
    egos, advs = [0, 1, 2, 0], [1, 5, 3, 7]
    assert texp.filter_valid_cat([_port_scene(s) for s in scenes], egos, advs) == \
        jexp.filter_valid_cat(scenes, egos, advs)


# -------------------------------------------------------------------- CLIs


def _toy_flags() -> list[str]:
    over = {**TOY, "eval.agent_slots": 0, "sim.max_agents": 12}
    return [x for k, v in over.items() for x in ("-o", f"{k}={v}")]


def test_eval_sim_cli_restores_a_port_checkpoint_on_the_cpu(tmp_path, capsys):
    from ctrl_sim_tpu_torch import eval_sim
    from ctrl_sim_tpu_torch.config import _set_dotted, preset
    from ctrl_sim_tpu_torch.train import parse_overrides
    from ctrl_sim_tpu_torch.training import Trainer
    from ctrl_sim_tpu_torch.training.checkpoint import CheckpointManager

    cfg = preset("ctrl_sim")
    for k, v in parse_overrides(_toy_flags()[1::2]).items():
        cfg = _set_dotted(cfg, k, v)
    state = Trainer(cfg, device="cpu").init_state(torch.Generator().manual_seed(7))
    state.step = 3
    CheckpointManager(cfg, str(tmp_path / "ckpt")).save(3, state)
    out = tmp_path / "metrics.json"
    metrics = eval_sim.main(["--device", "cpu", "--synthetic", "4", "--ckpt", str(tmp_path / "ckpt"),
                             "--out", str(out), *_toy_flags()])
    assert "restored step 3" in capsys.readouterr().out
    assert json.loads(out.read_text()) == metrics
    assert set(RATES) <= metrics.keys()
    for k, v in metrics.items():
        assert np.isfinite(v), k
        if k in RATES:
            assert 0 <= v <= 1
        if k.endswith("_jsd"):
            assert 0 <= v <= np.sqrt(np.log(2)) + 1e-12
    (tmp_path / "no_scenes").mkdir()
    with pytest.raises(FileNotFoundError, match="no \\*.json scene files"):  # the loaders are ported
        eval_sim.main(["--device", "cpu", "--data_dir", str(tmp_path / "no_scenes"), *_toy_flags()])


def test_eval_planner_cli_on_the_cpu():
    from ctrl_sim_tpu_torch import eval_planner

    flags = [*_toy_flags(), "-o", "eval.interesting_traj_len_threshold=5", "-o", "eval.history_steps=4"]
    metrics = eval_planner.main(["--device", "cpu", "--synthetic", "3", "--synthetic_conflict", "2", *flags])
    assert metrics, "no scene had an interesting (ego, adversary) pair"
    assert 0 <= metrics["ego_cr"] <= 1 and np.isfinite(metrics["ego_ade"])
