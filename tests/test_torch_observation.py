"""The port's observation API (``env/observation.py``, ``visible_light_features``,
``WaymoEnv.observe``) and the geometry it runs, held against the JAX package
on the same numpy-seeded inputs: visibility masks bit for bit on fixtures
without grazing contacts, features within 1e-5 in f32, the nearest-K
orders equal (a fixture ties on the ``road_edge_first`` key); the road
points and stop signs also against the literal numpy port of the C++ loops
in test_observation_roadpoints.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu import geometry as jgeo
from ctrl_sim_tpu.env import observation as jobs
from ctrl_sim_tpu.env import traffic_lights as jtl
from ctrl_sim_tpu.env.env import WaymoEnv as JaxEnv
from ctrl_sim_tpu_torch import geometry as tgeo
from ctrl_sim_tpu_torch.env import observation as tobs
from ctrl_sim_tpu_torch.env import traffic_lights as ttl
from ctrl_sim_tpu_torch.env.env import WaymoEnv as TorchEnv
from test_observation_roadpoints import _port_road_points, _scene as _roads_scene
from torch_port_common import configs, jax_scenario, scenes, t2n, torch_scenario

torch.set_num_threads(2)

T = torch.as_tensor
ATOL = 1e-5
VIEW = np.pi * (120.0 / 180.0)


def _boxes(rng, E, A, spread=40.0):
    pos = rng.uniform(-spread, spread, (E, A, 2)).astype(np.float32)
    hd = rng.uniform(-np.pi, np.pi, (E, A)).astype(np.float32)
    ln = rng.uniform(3.5, 6.0, (E, A)).astype(np.float32)
    wd = rng.uniform(1.6, 2.4, (E, A)).astype(np.float32)
    return pos, hd, ln, wd


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_rotation_matrix_and_rotate_equal_jax():
    rng = np.random.default_rng(0)
    yaw = rng.uniform(-4, 4, (7,)).astype(np.float32)
    np.testing.assert_allclose(t2n(tgeo.rotation_matrix(T(yaw))), np.asarray(jgeo.rotation_matrix(yaw)),
                               atol=1e-7)
    pts = rng.normal(size=(5, 3, 2)).astype(np.float32)
    for y in (0.3, -2.1):
        np.testing.assert_allclose(t2n(tgeo.rotate(T(pts), y)), np.asarray(jgeo.rotate(pts, jnp.float32(y))),
                                   atol=1e-6)


def test_point_in_polygon_and_segment_intersects_equal_jax():
    rng = np.random.default_rng(1)
    pos, hd, ln, wd = _boxes(rng, 1, 64, spread=10.0)
    corners = np.array(jgeo.obb_corners(pos[0], hd[0], ln[0], wd[0]))  # [64, 4, 2]
    p0 = rng.uniform(-15, 15, (64, 2)).astype(np.float32)
    p1 = rng.uniform(-15, 15, (64, 2)).astype(np.float32)
    p1[::8] = p0[::8]  # degenerate segments: point containment
    p0[3::8] = pos[0, 3::8]  # points inside their box
    p1[3::8] = p0[3::8]
    want = np.asarray(jgeo.obb_segment_intersects(corners, p0, p1))
    got = t2n(tgeo.obb_segment_intersects(T(corners), T(p0), T(p1)))
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    assert want[3::8].all()
    inside = np.asarray(jgeo.point_in_convex_polygon(p0, corners))
    np.testing.assert_array_equal(t2n(tgeo.point_in_convex_polygon(T(p0), T(corners))), inside)
    assert inside.any() and not inside.all()


def test_signed_distance_to_polyline_equal_jax():
    rng = np.random.default_rng(2)
    ang = np.linspace(0, 2 * np.pi, 12)
    poly = np.zeros((16, 2), np.float32)
    poly[:12] = np.stack([30 * np.cos(ang), 20 * np.sin(ang)], -1)  # closed, CCW
    xys = rng.uniform(-40, 40, (50, 2)).astype(np.float32)
    for n in (12, 7, 1):
        valid = np.arange(16) < n
        want = np.asarray(jgeo.signed_distance_to_polyline(xys, poly, valid))
        got = t2n(tgeo.signed_distance_to_polyline(T(xys), T(poly), T(valid)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# the observation's functions
# ---------------------------------------------------------------------------


def _jax_vis(pos, hd, ln, wd, ex, ego, **kw):
    f = jax.vmap(lambda p, h, l, w, e, i: jobs.visible_objects_mask(p, h, l, w, e, i, **kw))
    return np.asarray(f(pos, hd, ln, wd, ex, ego))


def _jax_fixtures():
    """The JAX tests' fixtures (test_observation.py) as [E = 1] batches."""
    a = ([[0.0, 0.0], [20.0, 0.0], [-20.0, 0.0], [500.0, 0.0], [40.0, 0.0]], [0.0] * 5, [4.5] * 5, [2.0] * 5)
    b = ([[0.0, 0.0], [10.0, 0.0], [15.0, 0.0]], [0.0, np.pi / 2, 0.0], [4.0, 20.0, 1.0], [2.0, 2.0, 0.5])
    return [tuple(np.asarray(x, np.float32)[None] for x in f) for f in (a, b)]


@pytest.mark.parametrize("case", ["objects", "truck", "random"])
def test_visible_objects_mask_equal_jax(case):
    if case == "random":
        pos, hd, ln, wd = _boxes(np.random.default_rng(3), 6, 12)
        ex = np.random.default_rng(4).random((6, 12)) > 0.15
        ego = np.arange(6, dtype=np.int32) % 12
    else:
        pos, hd, ln, wd = _jax_fixtures()[0 if case == "objects" else 1]
        ex = np.ones(pos.shape[:2], bool)
        ego = np.zeros(1, np.int32)
    for kw in ({}, {"view_dist": 30.0, "view_angle": np.pi, "head_angle": 0.4}):
        want = _jax_vis(pos, hd, ln, wd, ex, ego, **kw)
        got = t2n(tobs.visible_objects_mask(T(pos), T(hd), T(ln), T(wd), T(ex), T(ego), **kw))
        np.testing.assert_array_equal(got, want)
    if case == "truck":
        assert got[0, 1] and not got[0, 2]  # the small car hides behind the sideways truck
    if case == "random":
        assert want.sum() > 10 and (want != (want | True)).any()


def test_ego_state_and_flattened_visible_state_equal_jax():
    rng = np.random.default_rng(5)
    E, A = 5, 10
    pos, hd, ln, wd = _boxes(rng, E, A)
    spd = rng.uniform(0, 15, (E, A)).astype(np.float32)
    goal = rng.uniform(-50, 50, (E, A, 2)).astype(np.float32)
    types = rng.integers(-1, 6, (E, A)).astype(np.int32)  # out-of-range types one-hot to zero rows
    ex = rng.random((E, A)) > 0.1
    ego = rng.integers(0, A, E).astype(np.int32)
    vis = _jax_vis(pos, hd, ln, wd, ex, ego)
    rows = np.arange(E)
    want_es = np.asarray(jax.vmap(jobs.ego_state)(pos[rows, ego], hd[rows, ego], spd[rows, ego], ln[rows, ego],
                                                  wd[rows, ego], goal[rows, ego]))
    got_es = t2n(tobs.ego_state(*(T(x[rows, ego]) for x in (pos, hd, spd, ln, wd, goal))))
    np.testing.assert_allclose(got_es, want_es, atol=ATOL)
    for k, with_types in ((4, True), (16, True), (6, False)):
        f = jax.vmap(lambda p, h, s, l, w, v, i, ty: jobs.flattened_visible_state(
            p, h, s, l, w, v, i, max_visible_objects=k, agent_types=ty if with_types else None))
        want = np.asarray(f(pos, hd, spd, ln, wd, vis, ego, types))
        got = t2n(tobs.flattened_visible_state(T(pos), T(hd), T(spd), T(ln), T(wd), T(vis), T(ego),
                                               max_visible_objects=k, agent_types=T(types) if with_types else None))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)


def _jax_roads(rp, rt, ego_pos, ego_hd, corners, bmask, **kw):
    f = jax.vmap(lambda a, b, c, d, e, g: jobs.road_point_features(a, b, c, d, e, g, **kw))
    return np.asarray(f(rp, rt, ego_pos, ego_hd, corners, bmask))


def test_road_points_equal_jax_and_numpy_port():
    rp, rt = _roads_scene()
    corners = np.asarray(jgeo.obb_corners(np.float32([[30.0, 3.0]]), np.float32([0.0]), np.float32([6.0]),
                                          np.float32([3.0])))
    args = (rp[None], rt[None], np.zeros((1, 2), np.float32), np.zeros(1, np.float32), corners[None],
            np.ones((1, 1), bool))
    for edge_first in (True, False):
        kw = {"max_visible_road_points": 12, "road_edge_first": edge_first}
        want = _jax_roads(*args, **kw)
        got = t2n(tobs.road_point_features(*(T(x) for x in args), **kw))
        np.testing.assert_allclose(got, want, atol=ATOL)
        port = _port_road_points(rp, rt, np.zeros(2, np.float32), 0.0, [corners[0]], 12, edge_first,
                                 view_dist=80.0, view_angle=VIEW)
        np.testing.assert_allclose(got[0], port, atol=ATOL)


def test_road_points_random_scenes_equal_jax():
    rng = np.random.default_rng(6)
    E, P, L, A = 3, 10, 12, 8
    rp = np.zeros((E, P, L, 3), np.float32)
    rp[..., :2] = rng.uniform(-35, 35, (E, P, 1, 2)) + np.cumsum(rng.normal(0, 3, (E, P, L, 2)), axis=2)
    rp[..., 2] = (np.arange(L) < rng.integers(1, L + 1, (E, P, 1))).astype(np.float32)
    rt = np.zeros((E, P, 8), np.float32)
    rt[np.arange(E)[:, None], np.arange(P)[None], rng.integers(0, 8, (E, P))] = 1.0
    rt[:, -1] = -1.0  # padding rows
    pos, hd, ln, wd = _boxes(rng, E, A, spread=30.0)
    corners = np.asarray(jgeo.obb_corners(pos, hd, ln, wd))
    bmask = rng.random((E, A)) > 0.6
    ego_pos, ego_hd = pos[:, 0], hd[:, 0]
    for kw in ({"max_visible_road_points": 40},
               {"max_visible_road_points": 200, "road_edge_first": False, "view_dist": 50.0, "head_angle": -0.3}):
        args = (rp, rt, ego_pos, ego_hd, corners, bmask)
        want = _jax_roads(*args, **kw)
        got = t2n(tobs.road_point_features(*(T(x) for x in args), **kw))
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert (want[..., 0] > 0).sum() > 4


def test_road_edge_first_key_ties_in_index_order():
    """Points that tie on the float32 key keep their index order: two
    chunk rows sharing a point (equal distances), mirrored points, and two
    lane points 10.0004 m and 10.0 m away, whose keys round to one float32
    near 1e4 (the lexicographic order would put the nearer first)."""
    rp = np.zeros((1, 5, 4, 3), np.float32)
    rt = np.zeros((1, 5, 8), np.float32)
    rp[0, 0, :, :2] = [[5, 1], [8, 1], [11, 1], [14, 1]]  # road edge, its last point shared with row 1
    rp[0, 1, :2, :2] = [[14, 1], [17, 1]]
    rp[0, 2, :3, :2] = [[6, 3], [6, -3], [10.0004, 0]]  # lane: mirrored pair, then the farther tie
    rp[0, 3, :2, :2] = [[10.0, 0.0], [12, 2]]  # lane: the nearer tie
    rp[0, 4, :1, :2] = [[9, 0]]
    for p, n in enumerate((4, 2, 3, 2, 1)):
        rp[0, p, :n, 2] = 1.0
    rt[0, [0, 1], 3] = 1.0
    rt[0, [2, 3], 1] = 1.0
    rt[0, 4, 2] = 1.0
    kw = {"max_visible_road_points": 16}
    key_far = np.float32(np.float32(10.0004) + np.float32(2 * 80.0 + 1e4))
    assert key_far == np.float32(np.float32(10.0) + np.float32(2 * 80.0 + 1e4))  # the fixture does tie
    args = (rp, rt, np.zeros((1, 2), np.float32), np.zeros(1, np.float32), np.zeros((1, 1, 4, 2), np.float32),
            np.zeros((1, 1), bool))
    want = _jax_roads(*args, **kw)
    got = t2n(tobs.road_point_features(*(T(x) for x in args), **kw))
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, atol=ATOL)
    d = got[0, got[0, :, 0] > 0, 1]
    far, near = int(np.argmin(np.abs(d - 10.0004))), int(np.argmin(np.abs(d - 10.0)))
    assert far < near  # index order, not distance order, among the tied keys


def test_stop_signs_equal_jax():
    rp, rt = _roads_scene()
    rp2 = np.stack([rp, rp])
    rt2 = np.stack([rt, rt])
    ego_pos = np.float32([[0.0, 0.0], [3.0, -2.0]])
    for ego_hd in (np.float32([0.0, 0.7]), np.float32([np.pi, -2.0])):
        f = jax.vmap(lambda a, b, c, d: jobs.stop_sign_features(a, b, c, d, max_visible_stop_signs=4))
        want = np.asarray(f(rp2, rt2, ego_pos, ego_hd))
        got = t2n(tobs.stop_sign_features(T(rp2), T(rt2), T(ego_pos), T(ego_hd), max_visible_stop_signs=4))
        np.testing.assert_allclose(got, want, atol=ATOL)


def _lights(rng, E, L, T1):
    pos = rng.uniform(-40, 40, (E, L, 2)).astype(np.float32)
    state = rng.integers(0, 9, (E, L, T1)).astype(np.int8)
    valid = rng.random((E, L)) > 0.3
    return pos, state, valid


def test_visible_light_features_equal_jax():
    rng = np.random.default_rng(7)
    pos, state, valid = _lights(rng, 3, 7, 11)
    ego_pos = rng.uniform(-5, 5, (3, 2)).astype(np.float32)
    ego_hd = rng.uniform(-3, 3, 3).astype(np.float32)
    for t, k in ((0, 20), (4, 3), (15, 5)):
        f = jax.vmap(lambda p, s, v, e, h: jtl.visible_light_features(jtl.TrafficLights(p, s, v), jnp.asarray(t),
                                                                      e, h, max_visible=k))
        want = np.asarray(f(pos, state, valid, ego_pos, ego_hd))
        got = t2n(ttl.visible_light_features(ttl.TrafficLights(T(pos), T(state), T(valid)), t, T(ego_pos),
                                             T(ego_hd), max_visible=k))
        np.testing.assert_allclose(got, want, atol=ATOL)


# ---------------------------------------------------------------------------
# WaymoEnv.observe
# ---------------------------------------------------------------------------


def _with_lights(sb, rng):
    pos, state, valid = _lights(rng, sb.traj_position.shape[0], 5, sb.traj_position.shape[2])
    sb.tl_position, sb.tl_state, sb.tl_valid = pos, state, valid
    return sb


@pytest.mark.parametrize("lights", [False, True])
def test_observe_equal_jax(lights):
    jcfg, tcfg = configs()
    sb = scenes(jcfg, num_scenes=3, num_agents=10, seed0=20)
    if lights:
        sb = _with_lights(sb, np.random.default_rng(8))
    ego = np.asarray([0, 3, 5], np.int32)
    jsc, tsc = jax_scenario(sb), torch_scenario(sb)
    jenv, tenv = JaxEnv(jcfg), TorchEnv(tcfg)
    jst, tst = jenv.reset(jsc), tenv.reset(tsc)
    for kw in ({}, {"max_visible_objects": 4, "max_visible_road_points": 32, "max_visible_lights": 3,
                    "max_visible_stop_signs": 2, "view_dist": 40.0, "view_angle": math.pi / 2}):
        want = jax.jit(lambda s, st, e: jenv.observe(s, st, e, **kw))(jsc, jst, jnp.asarray(ego))
        got = tenv.observe(tsc, tst, T(ego), **kw)
        assert set(got) == set(want)
        for key in want:
            w, g = np.asarray(want[key]), t2n(got[key])
            assert g.shape == w.shape and g.dtype == w.dtype, key
            if w.dtype == bool:
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                np.testing.assert_allclose(g, w, atol=ATOL, err_msg=key)
        assert np.asarray(want["road_points"])[..., 0].sum() > 0
        assert (np.asarray(want["traffic_lights"])[..., 0].sum() > 0) == lights
