"""Real scene data into the port: the scene JSON loaders of both dialects,
the traffic lights, the native C++ loader and the entry points that read
scene directories, held against the JAX package.

- ``Scenario``'s optional fields (recorded rewards and actions, traffic
  lights) are the JAX package's, None by default;
- ``load_scenario_json`` of the port and of the JAX package on the
  raw-dialect fixture of ``tests/test_traffic_lights.py`` (with lights and
  without), on a raw-dialect scene that the port's ``export_raw_json``
  writes from a synthetic scene (with crossing agents and a light), and on
  physics-dialect files that the port's ``export_physics_json`` writes
  from a replay: every field equal, integer, mask and light fields bit
  for bit, floats within 1e-6; and their stacks, lighted and unlit scenes
  mixed;
- the port's native loader, built here with g++ from
  ``native/scenario_loader.cc``, against the port's Python loader on the
  same files (integers and masks bit for bit, floats within 1e-5, as
  ``tests/test_traffic_lights.py`` holds the JAX package's; headings modulo
  2 pi, since the C++ parse may give -pi for pi);
- ``parse_tl_states_np`` and ``state_at`` against the JAX package's;
- a store replayed from physics-dialect files (one state fewer than the
  replay reads) against the JAX package's;
- ``ScenarioStore.from_json_dir`` with ``limit`` and either loader,
  ``train.py --data_dir --val_dir`` (a ``val_loss`` line, the best
  checkpoint kept) and ``eval_sim.py --data_dir`` (finite metrics) on the
  CPU at a toy width."""

import dataclasses
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.config import _set_dotted as jax_set, load_config as jax_load_config
from ctrl_sim_tpu.data.scenario import Scenario as JaxScenario
from ctrl_sim_tpu.data.scenario import load_scenario_json as jax_load, stack_scenarios as jax_stack
from ctrl_sim_tpu.env import traffic_lights as jtl
from ctrl_sim_tpu_torch.config import _set_dotted, load_config
from ctrl_sim_tpu_torch.data.export import export_physics_json, export_raw_json
from ctrl_sim_tpu_torch.data.native_loader import load_scenario_json_native
from ctrl_sim_tpu_torch.data.scenario import Scenario, load_scenario_json, stack_scenarios
from ctrl_sim_tpu_torch.data.store import ScenarioStore, load_json_dir
from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario
from ctrl_sim_tpu_torch.env import traffic_lights as ttl
from test_traffic_lights import T1, _raw_scene_json

torch.set_num_threads(2)

FIXTURE = {  # the sizes of tests/test_traffic_lights.py's fixture
    "sim.steps": T1 - 1, "sim.max_agents": 4, "waymo.max_num_agents": 4,
    "waymo.max_num_road_polylines": 8, "waymo.max_num_road_pts_per_polyline": 10,
}
# the toy width of the CLI tests: 8 agents, 12 steps
TOY = {
    "model.hidden_dim": 32, "model.num_heads": 2, "model.dim_feedforward": 64, "model.num_decoder_layers": 1,
    "model.num_transformer_encoder_layers": 1, "waymo.train_context_length": 4, "waymo.max_num_agents": 8,
    "waymo.max_num_road_polylines": 8, "waymo.max_num_road_pts_per_polyline": 10, "sim.steps": 12,
    "sim.max_agents": 8, "train.global_batch_size": 4, "train.accum_steps": 2, "sim.history_steps": 4,
}
LIGHTS = _raw_scene_json(True)["tl_states"]


def _configs(over: dict):
    jcfg, tcfg = jax_load_config(), load_config()
    for k, v in over.items():
        jcfg, tcfg = jax_set(jcfg, k, v), _set_dotted(tcfg, k, v)
    return jcfg, tcfg


def _assert_scenes_equal(got, want, float_tol=1e-6, wrap_headings=False):
    """Every field of two scenes (or stacks) equal: integers, masks and
    light states bit for bit, floats within ``float_tol``; with
    ``wrap_headings``, headings modulo 2 pi."""
    for f in dataclasses.fields(JaxScenario):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "name" or b is None:
            assert a is None or f.name == "name", f.name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (f.name, a.shape, b.shape)
        if wrap_headings and f.name.endswith("heading"):
            a = b + (a - b + np.pi) % (2 * np.pi) - np.pi
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=float_tol, rtol=0, err_msg=f.name)
        else:
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    """(configs, {name: path}) of the fixture's scenes: the raw fixture with
    and without lights, a raw export of a synthetic scene with a crossing
    pair and the fixture's lights, and two physics exports of a replay (in
    a directory of their own)."""
    d = tmp_path_factory.mktemp("scenes")
    jcfg, tcfg = _configs(FIXTURE)
    files = {}
    for lights in (True, False):
        files[f"raw_lights_{lights}"] = d / f"raw_lights_{lights}.json"
        files[f"raw_lights_{lights}"].write_text(json.dumps(_raw_scene_json(lights)))
    synth = synthetic_scenario(tcfg, seed=5, num_agents=4, arena_half=60.0, num_lanes=2, conflict_pairs=1)
    files["raw_export"] = d / "raw_export.json"
    export_raw_json(synth, str(files["raw_export"]), tl_states=LIGHTS)
    scenes = [synthetic_scenario(tcfg, seed=s, num_agents=4, arena_half=60.0, num_lanes=2) for s in range(2)]
    store = ScenarioStore.from_scenes(tcfg, scenes, device="cpu")
    (d / "physics").mkdir()
    for e in range(2):
        files[f"physics_{e}"] = d / "physics" / f"physics_{e}.json"
        export_physics_json(tcfg, store.scenario, store.offline, e, str(files[f"physics_{e}"]))
    return jcfg, tcfg, {k: str(v) for k, v in files.items()}


def test_optional_fields_are_the_jax_packages():
    names = [f.name for f in dataclasses.fields(Scenario)]
    assert names == [f.name for f in dataclasses.fields(JaxScenario)]
    for name in ("rewards", "actions", "tl_position", "tl_state", "tl_valid"):
        assert dataclasses.fields(Scenario)[names.index(name)].default is None


@pytest.mark.parametrize("name", ["raw_lights_True", "raw_lights_False", "raw_export", "physics_0", "physics_1"])
def test_json_loader_matches_jax(scene_files, name):
    jcfg, tcfg, files = scene_files
    want = jax_load(files[name], jcfg)
    got = load_scenario_json(files[name], tcfg)
    _assert_scenes_equal(got, want)
    assert got.name == want.name == files[name]
    if name.startswith("physics"):
        assert got.rewards.shape[-1] == 8 and got.actions.shape[-1] == 2 and got.tl_state is None
    if name in ("raw_lights_True", "raw_export"):
        assert got.tl_state.dtype == np.int8 and got.tl_valid.all()
    # the same from the parsed dict, whose name is its "name" key
    with open(files[name]) as f:
        data = json.load(f)
    _assert_scenes_equal(load_scenario_json(data, tcfg), jax_load(data, jcfg))


def test_raw_export_reads_back_as_the_scene(scene_files):
    _, tcfg, files = scene_files
    synth = synthetic_scenario(tcfg, seed=5, num_agents=4, arena_half=60.0, num_lanes=2, conflict_pairs=1)
    got = load_scenario_json(files["raw_export"], tcfg)
    for f in dataclasses.fields(Scenario):
        want = getattr(synth, f.name)
        if not isinstance(want, np.ndarray):
            continue
        have = getattr(got, f.name)
        if f.name.endswith("heading"):  # an angle of pi may come back as -pi
            have = want + (have - want + np.pi) % (2 * np.pi) - np.pi
        np.testing.assert_allclose(have, want, atol=1e-4, rtol=0, err_msg=f.name)


def test_stacks_of_mixed_scenes_match_jax(scene_files):
    jcfg, tcfg, files = scene_files
    order = ["raw_lights_True", "raw_lights_False", "raw_export"]
    want = jax_stack([jax_load(files[n], jcfg) for n in order], jcfg)
    got = stack_scenarios([load_scenario_json(files[n], tcfg) for n in order], tcfg)
    _assert_scenes_equal(got, want)
    assert got.tl_state.shape == (3, 2, T1) and not got.tl_valid[1].any()
    physics = [f"physics_{e}" for e in range(2)]
    _assert_scenes_equal(stack_scenarios([load_scenario_json(files[n], tcfg) for n in physics], tcfg),
                         jax_stack([jax_load(files[n], jcfg) for n in physics], jcfg))


@pytest.mark.parametrize("name", ["raw_lights_True", "raw_lights_False", "raw_export", "physics_0"])
def test_native_loader_matches_python(scene_files, name):
    _, tcfg, files = scene_files
    # the C++ parse rounds headings in float32, so a heading of pi may come back as -pi
    _assert_scenes_equal(load_scenario_json_native(files[name], tcfg), load_scenario_json(files[name], tcfg),
                         float_tol=1e-5, wrap_headings=True)


def test_traffic_lights_match_jax():
    for max_lights in (None, 1, 4):
        want = jtl.parse_tl_states_np(LIGHTS, T1, max_lights)
        got = ttl.parse_tl_states_np(LIGHTS, T1, max_lights)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    jl, tl = jtl.parse_tl_states(LIGHTS, T1), ttl.parse_tl_states(LIGHTS, T1)
    for t in range(-T1 - 2, T1 + 3):
        np.testing.assert_array_equal(ttl.state_at(tl, t).numpy(), np.asarray(jtl.state_at(jl, jnp.asarray(t))))
    empty = ttl.TrafficLights.empty(3, T1)
    assert empty.state.shape == (3, T1) and not empty.valid.any()


def _write_dir(tcfg, directory, seeds, lights=False):
    os.makedirs(directory, exist_ok=True)
    for s in seeds:
        scene = synthetic_scenario(tcfg, seed=s, num_agents=6, arena_half=60.0, num_lanes=2, conflict_pairs=1)
        export_raw_json(scene, os.path.join(directory, f"scene_{s:03d}.json"), tl_states=LIGHTS if lights else None)
    return str(directory)


def test_store_from_json_dir_with_either_loader(tmp_path):
    _, tcfg = _configs(TOY)
    directory = _write_dir(tcfg, tmp_path / "train", range(5), lights=True)
    py = ScenarioStore.from_json_dir(tcfg, directory, limit=3, device="cpu")
    cc = ScenarioStore.from_json_dir(tcfg, directory, limit=3, device="cpu", native=True)
    assert py.num_scenes == cc.num_scenes == 3
    assert py.scenario.tl_state.dtype == torch.int64 and py.scenario.tl_state.shape[:2] == (3, 2)
    for a, b in zip(py.offline, cc.offline):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    assert [os.path.basename(s.name) for s in load_json_dir(tcfg, directory, limit=2)] == \
        ["scene_000.json", "scene_001.json"]
    with pytest.raises(FileNotFoundError):
        load_json_dir(tcfg, str(tmp_path / "empty"))


def test_physics_dir_replays_as_jax(scene_files, monkeypatch):
    """A store replayed from physics-dialect files (``sim.steps`` states a
    scene, one fewer than the replay reads: both packages clamp the last
    target to the last state) equals the JAX package's, with the JAX
    contact geometry given the port's corner tie rule."""
    import jax

    from ctrl_sim_tpu.data.store import ScenarioStore as JaxStore
    from torch_port_common import patch_jax_contact_tie_rule

    patch_jax_contact_tie_rule(monkeypatch)
    jcfg, tcfg, files = scene_files
    phys_dir = os.path.dirname(files["physics_0"])
    want = JaxStore.from_json_dir(jcfg, phys_dir)
    got = ScenarioStore.from_json_dir(tcfg, phys_dir, device="cpu")
    assert got.num_scenes == 2 and got.scenario.traj_position.shape[2] == tcfg.sim.steps
    for name, a, b in zip(got.offline._fields, got.offline, jax.tree.map(np.asarray, want.offline)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0, err_msg=name)


def test_train_main_with_data_and_val_dirs(tmp_path, capsys):
    from ctrl_sim_tpu_torch import train as torch_train

    _, tcfg = _configs(TOY)
    train_dir = _write_dir(tcfg, tmp_path / "train", range(6))
    val_dir = _write_dir(tcfg, tmp_path / "val", range(100, 103))
    save = tmp_path / "ckpt"
    args = ["--device", "cpu", "--data_dir", train_dir, "--val_dir", val_dir, "--val_every", "1",
            "--log_every", "1", "--save_dir", str(save), "--steps", "3", "-o", "train.keep_last_n=1"]
    for k, v in TOY.items():
        args += ["-o", f"{k}={v}"]
    torch_train.main(args)
    out = capsys.readouterr().out
    assert "[train] store: 6 scenes" in out and "[train] validation store: 3 scenes" in out
    vals = {int(line.split()[1].split("=")[1]): float(line.split("val_loss=")[1])
            for line in out.splitlines() if line.startswith("[val] step=")}
    assert sorted(vals) == [1, 2, 3] and all(math.isfinite(v) for v in vals.values())
    recorded = json.loads((save / "metrics.json").read_text())
    best = min(vals, key=vals.get)
    kept = sorted(int(p.name[5:-3]) for p in save.glob("step_*.pt"))
    assert kept == sorted({best, 3})  # the last and the best by val_loss
    assert recorded[str(best)]["val_loss"] == pytest.approx(vals[best])
    rows = [json.loads(r) for r in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "val_loss" in r] == [1, 2, 3]


def test_eval_sim_main_with_data_dir(tmp_path):
    from ctrl_sim_tpu_torch import eval_sim

    over = {**TOY, "eval.agent_slots": 0, "sim.history_steps": 4, "waymo.train_context_length": 4}
    _, tcfg = _configs(over)
    directory = _write_dir(tcfg, tmp_path / "test", range(200, 203))
    flags = [x for k, v in over.items() for x in ("-o", f"{k}={v}")]
    metrics = eval_sim.main(["--device", "cpu", "--data_dir", directory, "--native_loader", *flags])
    assert {"goal", "collision_rate", "offroad_rate", "ade", "fde"} <= metrics.keys()
    assert all(math.isfinite(v) for v in metrics.values())
