"""The port's contact solver (env/contacts.py) held against the JAX package:
``resolve_contacts`` on the fixtures of tests/test_contacts.py and on dense
random pileups, the env with contacts on step by step on synthetic scenes
whose vehicles touch, and the replay of the executed Box2D streams in
tests/goldens/reference_physics.npz within the bounds of
tests/test_physics_goldens.py.

Tolerances. The solver is 8 + 3 sweeps of float32 arithmetic over sums in
another order than XLA's, so the two sides agree to 1e-4, not bit for bit,
once both order a contact's two manifold points alike. They do not always:
the incident edge's two corners project equally in exact arithmetic, the
JAX code orders them by float32 rounding and the port by corner index
(``KEY_TIE``), and the friction and position sweeps take the points in
turn. So each comparison runs twice: against the JAX package as it is,
within ORDER_TOL (about 2.5 times the largest order effect measured on
these scenes), and against the JAX package with the port's tie rule
(``patch_jax_contact_tie_rule``), within 1e-4."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.data import stack_scenarios, synthetic_scenario
from ctrl_sim_tpu.env import contacts as jcon
from ctrl_sim_tpu.env import dynamics as jdyn
from ctrl_sim_tpu.env.env import WaymoEnv as JaxEnv
from ctrl_sim_tpu_torch.env import contacts as tcon
from ctrl_sim_tpu_torch.env import dynamics as tdyn
from ctrl_sim_tpu_torch.env.env import WaymoEnv as TorchEnv
from torch_port_common import configs, jax_scenario, patch_jax_contact_tie_rule, t2n, torch_scenario

torch.set_num_threads(2)

T = torch.as_tensor
ATOL = 1e-4
# the order of a contact's manifold points, as the JAX package's rounding
# picks it, moves a body by up to this much in one step of deep overlap
ORDER_TOL = {"position": 5e-2, "heading": 5e-2, "speed": 0.25, "velocity": 0.25, "angular_velocity": 0.1,
             "throttle_accel": 0.0, "brake_accel": 0.0}
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "reference_physics.npz")

# the fixtures of tests/test_contacts.py: (positions, headings, speeds,
# lengths, widths, dynamic, kinematic)
FIXTURES = {
    "head_on": ([[0.0, 0.0], [4.5, 0.0]], [0.0, np.pi], [5.0, 5.0], [5.0, 5.0], [2.0, 2.0], [1, 1], [0, 0]),
    "momentum": ([[0.0, 0.0], [4.0, 0.3]], [0.0, 0.5], [8.0, 1.0], [5.0, 4.0], [2.0, 1.8], [1, 1], [0, 0]),
    "rear_end": ([[0.0, 0.0], [4.8, 0.0]], [0.0, 0.0], [10.0, 0.0], [5.0, 5.0], [2.0, 2.0], [1, 1], [0, 0]),
    "mass_ratio": ([[0.0, 0.0], [5.3, 0.0]], [0.0, 0.0], [10.0, 0.0], [9.0, 3.0], [3.0, 1.5], [1, 1], [0, 0]),
    "kinematic_wall": ([[0.0, 0.0], [4.8, 0.0]], [0.0, 0.0], [10.0, 0.0], [5.0, 5.0], [2.0, 2.0], [1, 0], [0, 1]),
    "non_touching": ([[0.0, 0.0], [50.0, 0.0]], [0.0, 0.0], [5.0, 5.0], [5.0, 5.0], [2.0, 2.0], [1, 1], [0, 0]),
    "static_overlap": ([[0.0, 0.0], [4.0, 0.0]], [0.0, 0.0], [0.0, 0.0], [5.0, 5.0], [2.0, 2.0], [1, 1], [0, 0]),
    "dead_at_sentinel": ([[-1e6, -1e6], [-1e6, -1e6], [0.0, 0.0]], [0.0, 0.0, 0.0], [0.0, 0.0, 5.0],
                         [5.0, 5.0, 5.0], [2.0, 2.0, 2.0], [0, 0, 1], [0, 0, 0]),
}


def _jax_solve(pre, proposed, length, width, dynamic, kinematic, dt=0.1):
    """The JAX solver vmapped over the scene axis, as the JAX env calls it."""
    return jax.jit(jax.vmap(lambda a, b, ln, wd, dy, ki: jcon.resolve_contacts(a, b, ln, wd, dy, ki, dt)))(
        pre, proposed, length, width, dynamic, kinematic)


def _compare(got, want, tol=None):
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=tol[name] if tol else ATOL, rtol=1e-6,
                                   err_msg=name)


def _both_sides(pos, hd, spd, vel, ang, length, width, dynamic, kinematic):
    """Both solvers on the same [E, A] inputs, the proposal equal to the
    pre-step bodies with the given velocities."""
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    pos, hd, spd, vel, ang, length, width = map(f32, (pos, hd, spd, vel, ang, length, width))
    zero = np.zeros_like(hd)
    jb = jdyn.BodyState(*map(jnp.asarray, (pos, hd, spd, vel, ang, zero, zero)))
    tb = tdyn.BodyState(*map(T, (pos, hd, spd, vel, ang, zero, zero)))
    dynamic, kinematic = np.asarray(dynamic, bool), np.asarray(kinematic, bool)
    want = _jax_solve(jb, jb, jnp.asarray(length), jnp.asarray(width), jnp.asarray(dynamic), jnp.asarray(kinematic))
    got = tcon.resolve_contacts(tb, tb, T(length), T(width), T(dynamic), T(kinematic), 0.1)
    return got, want


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_resolve_contacts_fixtures_match_jax(name):
    pos, hd, spd, ln, wd, dyn, kin = FIXTURES[name]
    b = jdyn.body_state_from_pose(jnp.asarray(pos, jnp.float32), jnp.asarray(hd, jnp.float32),
                                  jnp.asarray(spd, jnp.float32))
    got, want = _both_sides([pos], [hd], [spd], [np.asarray(b.velocity)], [np.zeros(len(hd))], [ln], [wd],
                            [dyn], [kin])
    _compare(got, want)


@pytest.mark.parametrize("tie_rule", ["jax", "port"])
def test_resolve_contacts_dense_pileups_match_jax(monkeypatch, tie_rule):
    """Four scenes of ten cars packed into a few car lengths, with random
    velocities, spins, sizes and one kinematic car each, plus one scene
    without contact (its bodies keep the proposal, as under lax.cond)."""
    if tie_rule == "port":
        patch_jax_contact_tie_rule(monkeypatch)
    rng = np.random.default_rng(0)
    E, A = 5, 10
    pos = rng.uniform(-8, 8, size=(E, A, 2))
    pos[-1] = np.stack([np.arange(A) * 30.0, np.zeros(A)], -1)  # far apart
    hd = rng.uniform(-np.pi, np.pi, size=(E, A))
    vel = rng.normal(size=(E, A, 2)) * 4
    ang = rng.normal(size=(E, A)) * 0.3
    spd = np.linalg.norm(vel, axis=-1)
    ln, wd = rng.uniform(3.5, 6, size=(E, A)), rng.uniform(1.6, 2.4, size=(E, A))
    kin = np.zeros((E, A), bool)
    kin[:, 0] = True
    dyn = ~kin
    dyn[:, -1] = False  # a body in neither set passes through
    got, want = _both_sides(pos, hd, spd, vel, ang, ln, wd, dyn, kin)
    _compare(got, want, ORDER_TOL if tie_rule == "jax" else None)
    moved = np.abs(np.asarray(want.velocity) - vel.astype(np.float32)).max(axis=(1, 2))
    assert (moved[:-1] > 0.1).all() and moved[-1] == 0.0


@pytest.mark.parametrize("dynamics,tie_rule", [("physics", "jax"), ("physics", "port"), ("kinematic", "jax")])
def test_env_with_contacts_matches_jax(monkeypatch, dynamics, tie_rule):
    """reset, reward and step under inverse-bicycle GT replay with contacts
    on, on crowded scenes (12 agents in a 25 m arena, two crossing pairs)
    where vehicles touch; one agent is on expert teleport (kinematic for
    the solver)."""
    if tie_rule == "port":
        patch_jax_contact_tie_rule(monkeypatch)
    tol = ORDER_TOL if tie_rule == "jax" else {}
    jcfg, tcfg = configs(**{"sim.dynamics": dynamics, "sim.resolve_contacts": True})
    sb = stack_scenarios(
        [synthetic_scenario(jcfg, seed=s, num_agents=12, arena_half=25.0, num_lanes=2, conflict_pairs=2)
         for s in range(4)], jcfg)
    js, ts = jax_scenario(sb), torch_scenario(sb)
    jenv, tenv = JaxEnv(jcfg), TorchEnv(tcfg)
    expert = np.zeros(sb.agent_valid.shape, bool)
    expert[:, 2] = True

    @jax.jit
    def jax_step(js, jst, t):
        jr, jst = jenv.reward(js, jst)
        b = jst.bodies
        acc, steer = jdyn.inverse_bicycle_action(
            js.traj_position[:, :, t + 1], js.traj_heading[:, :, t + 1], js.traj_speed[:, :, t + 1],
            b.position, b.heading, b.speed, js.length, jcfg.sim.dt,
        )
        alive_next = jst.alive & js.traj_valid[:, :, t + 1]
        nxt, _ = jenv.step(js, jst, acc, steer, jnp.asarray(expert), alive_next)
        return jr, acc, steer, alive_next, nxt

    jst, tst = jax.jit(jenv.reset)(js), tenv.reset(ts)
    off = TorchEnv(configs(**{"sim.dynamics": dynamics})[1])
    contact_steps = 0
    for t in range(jcfg.sim.steps):
        jr, acc, steer, alive_next, jst = jax_step(js, jst, jnp.asarray(t, jnp.int32))
        tr, tst_r = tenv.reward(ts, tst)
        np.testing.assert_allclose(t2n(tr), np.asarray(jr), atol=1e-5, err_msg=f"reward8 t={t}")
        args = (T(np.array(acc)), T(np.array(steer)), T(expert), T(np.array(alive_next)))
        free = off.step(ts, tst_r, *args)
        tst = tenv.step(ts, tst_r, *args)
        for name in ("position", "heading", "speed", "velocity", "angular_velocity"):
            a, b = t2n(getattr(tst.bodies, name)), np.asarray(getattr(jst.bodies, name))
            if name == "heading":  # compare on the circle
                a, b = np.angle(np.exp(1j * (a - b))), np.zeros_like(b)
            np.testing.assert_allclose(a, b, atol=tol.get(name, ATOL), rtol=1e-5, err_msg=f"{name} t={t}")
        if not tol:  # the flags are thresholds on positions that ORDER_TOL lets differ
            np.testing.assert_array_equal(t2n(tst.veh_veh_collision), np.asarray(jst.veh_veh_collision))
            np.testing.assert_array_equal(t2n(tst.veh_edge_collision), np.asarray(jst.veh_edge_collision))
        contact_steps += int(not torch.equal(free.bodies.position, tst.bodies.position))
        # the JAX env's state carries on from the port's, so differences
        # cannot compound across steps
        jst = jst._replace(
            bodies=jdyn.BodyState(*(jnp.asarray(t2n(x)) for x in tst.bodies)),
            veh_veh_collision=jnp.asarray(t2n(tst.veh_veh_collision)),
            veh_edge_collision=jnp.asarray(t2n(tst.veh_edge_collision)),
        )
    if dynamics == "physics":
        assert contact_steps >= 3, "the scenes should make vehicles touch"
    else:
        assert contact_steps == 0, "the kinematic contract runs no contact solver"


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def _rollout(init, actions, dt, contacts):
    """freecar_step (+ resolve_contacts) over an action stream, one scene;
    returns [T, n, 4] (x, y, heading, speed)."""
    length, width = T(init[None, :, 1]), T(init[None, :, 0])
    state = tdyn.body_state_from_pose(T(init[None, :, 2:4]), T(init[None, :, 4]), T(init[None, :, 5]))
    dynamic = torch.ones_like(length, dtype=torch.bool)
    out = []
    for act in T(actions):
        nxt = tdyn.freecar_step(state, act[None, :, 0], act[None, :, 1], length, dt)
        if contacts:
            nxt = tcon.resolve_contacts(state, nxt, length, width, dynamic, torch.zeros_like(dynamic), dt)
        state = nxt
        out.append(torch.cat([nxt.position[0], nxt.heading[0, :, None], nxt.speed[0, :, None]], -1))
    return t2n(torch.stack(out))


# the bounds of tests/test_physics_goldens.py:104-109 (m)
_FINAL_BOUND = {"collide_headon": 0.05, "collide_tbone": 0.8, "collide_oblique": 0.1, "pileup3": 0.25}


@pytest.mark.parametrize("name", sorted(_FINAL_BOUND))
def test_replay_of_executed_box2d_within_golden_bounds(goldens, name):
    """test_physics_goldens.py:test_collision_parity for the port: exact
    before contact, at least 80% of the contact effect, and the final
    deviation inside the JAX package's bound."""
    init, actions, ref = goldens[f"{name}_init"], goldens[f"{name}_actions"], goldens[f"{name}_states"]
    dt = float(goldens["dt"])
    traj = _rollout(init, actions, dt, contacts=True)
    free = _rollout(init, actions, dt, contacts=False)
    err = np.linalg.norm(traj[..., :2] - ref[..., :2], axis=-1)
    contact_t = int(np.argmax(np.abs(free[..., :2] - ref[..., :2]).max(axis=(1, 2)) > 1e-3))
    assert contact_t > 5
    assert err[: contact_t - 1].max() < 2e-4
    nocontact_final = np.linalg.norm(free[-1, :, :2] - ref[-1, :, :2], axis=-1).max()
    assert err[-1].max() < 0.2 * nocontact_final
    assert err[-1].max() < _FINAL_BOUND[name]
