"""The port's ``viz.py`` held against the JAX package's on the same scene:
``feature_image`` equal bit for bit (whole scene, ego-centric, goals,
traffic lights), ``render_frame`` and ``render_ego_cone`` equal pixel for
pixel on an Agg canvas, and ``render_rollout``'s frames equal image for
image."""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ctrl_sim_tpu import viz as jviz  # noqa: E402
from ctrl_sim_tpu.config import load_config  # noqa: E402
from ctrl_sim_tpu.data import synthetic_scenario  # noqa: E402
from ctrl_sim_tpu.rollout.rollout import RolloutOutput as JaxRolloutOutput  # noqa: E402
from ctrl_sim_tpu_torch import viz as tviz  # noqa: E402
from ctrl_sim_tpu_torch.config import load_config as torch_load_config  # noqa: E402
from ctrl_sim_tpu_torch.rollout.rollout import RolloutOutput  # noqa: E402
from torch_port_common import torch_scenario  # noqa: E402

torch.set_num_threads(2)

OVER = {"sim.max_agents": 6, "waymo.max_num_agents": 6, "waymo.max_num_road_polylines": 12,
        "waymo.max_num_road_pts_per_polyline": 20, "sim.steps": 6}


def _scene(lights: bool = False):
    sc = synthetic_scenario(load_config(OVER), seed=0, num_agents=4, arena_half=60.0, num_lanes=3)
    if lights:
        rng = np.random.default_rng(0)
        sc.tl_position = rng.uniform(-40, 40, (3, 2)).astype(np.float32)
        sc.tl_state = rng.integers(0, 9, (3, sc.traj_position.shape[1])).astype(np.int8)
        sc.tl_valid = np.array([True, False, True])
    return sc, torch_scenario(sc)


@pytest.mark.parametrize("case", ["whole", "ego", "ego-unrotated-goals", "lights"])
def test_feature_image_equal_jax(case):
    sc, tsc = _scene(lights=case == "lights")
    pos, hd = sc.traj_position[:, 0].copy(), sc.traj_heading[:, 0].copy()
    alive = sc.agent_valid & sc.traj_valid[:, 0]
    kw = {"whole": {"ego_index": None, "img_size": 128},
          "ego": {"ego_index": 0, "img_size": 160, "view_dist": 40.0},
          "ego-unrotated-goals": {"ego_index": 1, "rotate_with_ego": False, "draw_goals": True},
          "lights": {"ego_index": None, "img_size": 96}}[case]
    want = jviz.feature_image(sc, pos, hd, alive, **kw)
    got = tviz.feature_image(tsc, torch.as_tensor(pos), torch.as_tensor(hd), torch.as_tensor(alive), **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (want > 0).any()


def _canvas(draw) -> np.ndarray:
    fig, ax = plt.subplots(figsize=(3, 3), dpi=60)
    draw(ax)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return img


def test_render_frame_and_ego_cone_equal_jax():
    sc, tsc = _scene()
    pos, hd = sc.traj_position[:, 2], sc.traj_heading[:, 2]
    exist = (sc.agent_valid & sc.traj_valid[:, 2]).astype(np.float32)
    controlled = np.array([True, False, True, False, False, False])
    collided = np.array([False, True, False, False, False, False])
    t = torch.as_tensor

    def jdraw(ax):
        jviz.render_frame(ax, sc, pos, hd, exist, controlled=controlled, collided=collided)
        jviz.render_ego_cone(ax, sc, pos, hd, exist, ego_index=0)

    def tdraw(ax):
        tviz.render_frame(ax, tsc, t(pos), t(hd), t(exist), controlled=controlled, collided=collided)
        tviz.render_ego_cone(ax, tsc, t(pos), t(hd), t(exist), ego_index=0)

    want, got = _canvas(jdraw), _canvas(tdraw)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want.reshape(-1, 4), axis=0)) > 4


def test_render_rollout_frames_equal_jax(tmp_path):
    sc, tsc = _scene()
    T1, A = sc.traj_position.shape[1], sc.traj_position.shape[0]
    rng = np.random.default_rng(1)
    arrays = {
        "position": sc.traj_position.transpose(1, 0, 2)[:, None],
        "velocity": np.zeros((T1, 1, A, 2), np.float32),
        "heading": sc.traj_heading.T[:, None],
        "speed": sc.traj_speed.T[:, None],
        "existence": sc.traj_valid.T[:, None].astype(np.float32),
        "reward8": (rng.random((T1 - 1, 1, A, 8)) > 0.8).astype(np.float32),
        "acceleration": np.zeros((T1 - 1, 1, A), np.float32),
        "steering": np.zeros((T1 - 1, 1, A), np.float32),
        "nearest_dist": np.zeros((T1, 1, A), np.float32),
        "rtgs": np.zeros((T1 - 1, 1, A, 3), np.float32),
        "controlled_mask": sc.agent_valid[None],
    }
    jro = JaxRolloutOutput(**{k: v for k, v in arrays.items() if k in JaxRolloutOutput._fields})
    tro = RolloutOutput(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    want = jviz.render_rollout(load_config(OVER), sc, jro, 0, str(tmp_path / "jax"), every=3)
    got = tviz.render_rollout(torch_load_config(OVER), tsc, tro, 0, str(tmp_path / "torch"), every=3)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] and len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(mpimg.imread(g), mpimg.imread(w))
