"""The port's config, scenes, geometry, dynamics and environment held
against the JAX package on the same inputs (contacts off)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ctrl_sim_tpu.config as jcfg_mod
import ctrl_sim_tpu_torch.config as tcfg_mod
from ctrl_sim_tpu import geometry as jgeo
from ctrl_sim_tpu.data import transforms as jtf
from ctrl_sim_tpu.data.pipeline import goals_from_scenario as jgoals
from ctrl_sim_tpu.env import dynamics as jdyn
from ctrl_sim_tpu.env.env import WaymoEnv as JaxEnv
from ctrl_sim_tpu_torch import geometry as tgeo
from ctrl_sim_tpu_torch.data import stack_scenarios, synthetic_scenario
from ctrl_sim_tpu_torch.data import transforms as ttf
from ctrl_sim_tpu_torch.data.pipeline import goals_from_scenario as tgoals
from ctrl_sim_tpu_torch.env import dynamics as tdyn
from ctrl_sim_tpu_torch.env.env import WaymoEnv as TorchEnv
from torch_port_common import configs, jax_scenario, scenes, t2n, torch_scenario

torch.set_num_threads(2)

T = torch.as_tensor


def _defaults(cls):
    return {
        f.name: (f.default if f.default is not dataclasses.MISSING else f.default_factory())
        for f in dataclasses.fields(cls)
    }


@pytest.mark.parametrize(
    "name",
    ["SimConfig", "PhysicsConfig", "RewardConfig", "WaymoDatasetConfig", "ModelConfig",
     "TrainConfig", "TiltConfig", "PolicyConfig", "EvalConfig"],
)
def test_config_fields_and_defaults_equal_jax(name):
    ours = {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in _defaults(getattr(tcfg_mod, name)).items()}
    ref = {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
           for k, v in _defaults(getattr(jcfg_mod, name)).items()}
    assert ours == ref


def test_config_top_level_and_dotted_overrides():
    ours = [f.name for f in dataclasses.fields(tcfg_mod.Config)]
    assert set(ours) <= {f.name for f in dataclasses.fields(jcfg_mod.Config)}
    over = {"model.hidden_dim": 96, "sim.physics.max_speed": 7.0, "eval.agent_slots": 8}
    a, b = tcfg_mod.load_config(over), jcfg_mod.load_config(over)
    for sec in ours:
        assert dataclasses.asdict(getattr(a, sec)) == dataclasses.asdict(getattr(b, sec))


def test_synthetic_scenes_equal_jax():
    jcfg, tcfg = configs()
    ref = scenes(jcfg, num_scenes=3, num_agents=7)
    ours = stack_scenarios(
        [synthetic_scenario(tcfg, seed=s, num_agents=7, arena_half=60.0, num_lanes=2) for s in range(3)],
        tcfg,
    )
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_angles_se2_and_boxes_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(-10, 10, size=64).astype(np.float32)
    b = rng.uniform(-10, 10, size=64).astype(np.float32)
    for jf, tf_ in ((jgeo.angle_sub, tgeo.angle_sub), (jgeo.angle_add, tgeo.angle_add)):
        np.testing.assert_allclose(t2n(tf_(T(a), T(b))), np.asarray(jf(a, b)), atol=1e-5)
    pts = rng.normal(size=(5, 7, 2)).astype(np.float32) * 30
    tr = rng.normal(size=(5, 2)).astype(np.float32) * 10
    yaw = rng.uniform(-np.pi, np.pi, size=5).astype(np.float32)
    want = np.stack([np.asarray(jgeo.apply_se2(pts[i], tr[i], yaw[i])) for i in range(5)])
    got = t2n(tgeo.apply_se2(T(pts), T(tr)[:, None], T(yaw)))
    np.testing.assert_allclose(got, want, atol=1e-4)

    pos = rng.normal(size=(2, 9, 2)).astype(np.float32) * 4
    hd = rng.uniform(-np.pi, np.pi, size=(2, 9)).astype(np.float32)
    ln = rng.uniform(3, 6, size=(2, 9)).astype(np.float32)
    wd = rng.uniform(1.5, 2.5, size=(2, 9)).astype(np.float32)
    jc = np.asarray(jgeo.obb_corners(pos, hd, ln, wd))
    tc = tgeo.obb_corners(T(pos), T(hd), T(ln), T(wd))
    np.testing.assert_allclose(t2n(tc), jc, atol=1e-5)
    np.testing.assert_array_equal(
        t2n(tgeo.obb_obb_intersects(tc[:, :, None], tc[:, None])),
        np.asarray(jgeo.obb_obb_intersects(jc[:, :, None], jc[:, None])),
    )
    p0 = rng.normal(size=(2, 40, 2)).astype(np.float32) * 6
    p1 = p0 + rng.normal(size=(2, 40, 2)).astype(np.float32) * 4
    p1[:, :3] = p0[:, :3]  # degenerate segments
    want = np.stack([np.asarray(jgeo.obb_segment_hits(pos[e], hd[e], ln[e], wd[e], p0[e], p1[e])) for e in range(2)])
    got = t2n(tgeo.obb_segment_hits(T(pos), T(hd), T(ln), T(wd), T(p0), T(p1)))
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_signed_distance_matches_jax():
    jcfg, _ = configs()
    sb = scenes(jcfg, num_scenes=2)
    rng = np.random.default_rng(1)
    xy = rng.uniform(-70, 70, size=(2, 25, 2)).astype(np.float32)
    want = np.stack([
        np.asarray(jgeo.signed_distance_to_polylines(xy[e], sb.edge_polylines[e], sb.edge_poly_valid[e]))
        for e in range(2)
    ])
    got = t2n(tgeo.signed_distance_to_polylines(T(xy), T(sb.edge_polylines), T(sb.edge_poly_valid)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (want < 0).any() and (want > 0).any()


def test_dynamics_match_jax():
    rng = np.random.default_rng(2)
    n = (3, 10)
    f = lambda *s: rng.normal(size=n + s).astype(np.float32)  # noqa: E731
    pos, vel = f(2) * 10, f(2) * 5
    hd = rng.uniform(-3, 3, size=n).astype(np.float32)
    spd, ang = np.abs(f()) * 5, f() * 0.1
    thr, brk = np.abs(f()), np.abs(f()) * (rng.random(n) > 0.5)
    acc, steer = f() * 3, f() * 0.3
    acc[0, :3] = [0.0005, -0.0005, 0.0]  # below the brake deadband
    ln = rng.uniform(3.5, 5.5, size=n).astype(np.float32)
    jb = jdyn.BodyState(pos, hd, spd, vel, ang, thr, brk)
    tb = tdyn.BodyState(*map(T, (pos, hd, spd, vel, ang, thr, brk)))
    js = jdyn.freecar_step(jb, acc, steer, ln, 0.1)
    ts = tdyn.freecar_step(tb, T(acc), T(steer), T(ln), 0.1)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-5)
    for a, b in zip(
        tdyn.kinematic_bicycle_step(T(pos), T(hd), T(spd), T(acc), T(steer), T(ln), 0.1),
        jdyn.kinematic_bicycle_step(pos, hd, spd, acc, steer, ln, 0.1),
    ):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-5)
    hd2 = hd + f() * 0.05
    spd2 = spd + f()
    for a, b in zip(
        tdyn.inverse_bicycle_action(T(pos), T(hd2), T(spd2), T(pos), T(hd), T(spd), T(ln), 0.1),
        jdyn.inverse_bicycle_action(pos, hd2, spd2, pos, hd, spd, ln, 0.1),
    ):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("dynamics", ["physics", "kinematic"])
def test_env_gt_replay_matches_jax(dynamics):
    """reset, reward and step under inverse-bicycle GT replay actions, with
    one agent on expert teleport and the GT existence chain."""
    jcfg, tcfg = configs(**{"sim.dynamics": dynamics})
    sb = scenes(jcfg, num_scenes=4)
    js, ts = jax_scenario(sb), torch_scenario(sb)
    jenv, tenv = JaxEnv(jcfg), TorchEnv(tcfg)
    expert = np.zeros(sb.agent_valid.shape, bool)
    expert[:, 2] = True

    @jax.jit
    def jax_step(js, jst, t):
        """reward, GT replay actions, step: returns (reward8, actions, next state)."""
        jr, jst = jenv.reward(js, jst)
        b = jst.bodies
        acc, steer = jdyn.inverse_bicycle_action(
            js.traj_position[:, :, t + 1], js.traj_heading[:, :, t + 1], js.traj_speed[:, :, t + 1],
            b.position, b.heading, b.speed, js.length, jcfg.sim.dt,
        )
        alive_next = jst.alive & js.traj_valid[:, :, t + 1]
        jst, _ = jenv.step(js, jst, acc, steer, jnp.asarray(expert), alive_next)
        return jr, acc, steer, alive_next, jst

    jst, tst = jax.jit(jenv.reset)(js), tenv.reset(ts)
    for t in range(jcfg.sim.steps):
        jr, acc, steer, alive_next, jst = jax_step(js, jst, jnp.asarray(t, jnp.int32))
        tr, tst = tenv.reward(ts, tst)
        np.testing.assert_allclose(t2n(tr), np.asarray(jr), atol=1e-5, err_msg=f"reward8 t={t}")
        tst = tenv.step(ts, tst, T(np.array(acc)), T(np.array(steer)), T(expert), T(np.array(alive_next)))
        np.testing.assert_allclose(t2n(tst.bodies.position), np.asarray(jst.bodies.position), atol=1e-4)
        np.testing.assert_allclose(t2n(tst.bodies.heading), np.asarray(jst.bodies.heading), atol=1e-4)
        np.testing.assert_array_equal(t2n(tst.veh_veh_collision), np.asarray(jst.veh_veh_collision))
        np.testing.assert_array_equal(t2n(tst.veh_edge_collision), np.asarray(jst.veh_edge_collision))
    assert t2n(tst.position_achieved).any()


def test_env_refuses_contacts():
    _, tcfg = configs(**{"sim.resolve_contacts": True})
    with pytest.raises(NotImplementedError):
        TorchEnv(tcfg)


def test_transforms_match_jax():
    jcfg, tcfg = configs()
    wc = jcfg.waymo
    rng = np.random.default_rng(3)
    actions = np.stack([rng.uniform(-12, 12, 500), rng.uniform(-0.8, 0.8, 500)], -1).astype(np.float32)
    ids = np.array(jtf.discretize_actions(actions, wc))
    np.testing.assert_array_equal(t2n(ttf.discretize_actions(T(actions), tcfg.waymo)), ids)
    np.testing.assert_allclose(
        t2n(ttf.undiscretize_actions(T(ids.astype(np.int64)), tcfg.waymo)),
        np.asarray(jtf.undiscretize_actions(ids.astype(np.int32), wc)), atol=1e-6,
    )
    rtgs = rng.uniform(-20, 100, size=(50, 3)).astype(np.float32)
    norm = np.array(jtf.normalize_rtgs(rtgs, wc))
    np.testing.assert_allclose(t2n(ttf.normalize_rtgs(T(rtgs), tcfg.waymo)), norm, atol=1e-6)
    bins = np.array(jtf.discretize_rtgs(norm, wc))
    np.testing.assert_array_equal(t2n(ttf.discretize_rtgs(T(norm), tcfg.waymo)), bins)
    np.testing.assert_allclose(
        t2n(ttf.undiscretize_rtgs(T(bins), tcfg.waymo)), np.asarray(jtf.undiscretize_rtgs(bins, wc)), atol=1e-5
    )
    np.testing.assert_allclose(
        t2n(ttf.get_tilt_logits(-3.0, 2.0, 0.5, tcfg.waymo, device="cpu")),
        np.asarray(jtf.get_tilt_logits(-3.0, 2.0, 0.5, wc)), atol=1e-6,
    )
    sb = scenes(jcfg, num_scenes=2)
    np.testing.assert_allclose(
        t2n(tgoals(torch_scenario(sb))), np.asarray(jgoals(jax_scenario(sb))), atol=1e-5
    )
