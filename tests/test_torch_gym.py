"""The port's ``env/gym.py:observation_replay`` held against the JAX one on
the same scenes (toy widths, contacts off and on; on, under the contact
solver's shared tie rule, ``patch_jax_contact_tie_rule``): every
observation stream with its masks bit for bit and its features within
1e-5, and the privileged position and reward streams; then, at full width,
against ``tests/goldens/reference_observation.npz``, the JAX package's
stream written by tools/make_observation_goldens.py, which
``chip_smoke.py`` holds the card to."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.env.gym import observation_replay as jax_replay
from ctrl_sim_tpu_torch.config import load_config as torch_load_config
from ctrl_sim_tpu_torch.data import to_torch
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.env.gym import observation_replay
from torch_port_common import configs, jax_scenario, patch_jax_contact_tie_rule, scenes, t2n, torch_scenario

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "reference_observation.npz")
SMALL = {"sim.steps": 10, "sim.max_agents": 8, "waymo.max_num_agents": 8}
CAPS = {"max_visible_objects": 5, "max_visible_road_points": 40, "max_visible_lights": 3,
        "max_visible_stop_signs": 2}


def _assert_streams(got: dict, want: dict, atol: float) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        g = t2n(got[key])
        w = np.asarray(w)
        assert g.shape == w.shape, (key, g.shape, w.shape)
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize("contacts", [False, True])
def test_observation_replay_equals_jax(contacts, monkeypatch):
    if contacts:
        patch_jax_contact_tie_rule(monkeypatch)
    jcfg, tcfg = configs(**SMALL, **{"sim.resolve_contacts": contacts})
    sb = scenes(jcfg, num_scenes=2, num_agents=7, seed0=30)
    rng = np.random.default_rng(9)
    sb.tl_position = rng.uniform(-30, 30, (2, 3, 2)).astype(np.float32)
    sb.tl_state = rng.integers(0, 9, (2, 3, sb.traj_position.shape[2])).astype(np.int8)
    sb.tl_valid = np.array([[True, True, False], [True, False, True]])
    ego = np.asarray([1, 4], np.int32)
    want_obs, want_traj = jax.jit(lambda s, e: jax_replay(jcfg, s, e, **CAPS))(jax_scenario(sb), jnp.asarray(ego))
    got_obs, got_traj = observation_replay(tcfg, torch_scenario(sb), torch.as_tensor(ego), **CAPS)
    _assert_streams(got_obs, want_obs, 1e-5)
    _assert_streams(got_traj, want_traj, 1e-4)
    assert got_obs["visible_objects"].shape == (10, 2, 5, 13)
    assert float(got_obs["road_points"][..., 0].sum()) > 0 and float(got_obs["traffic_lights"][..., 0].sum()) > 0


def golden_scenario(device="cpu"):
    """The golden's config, scenes and egos, for the port (no JAX needed)."""
    z = np.load(GOLDEN)
    cfg = torch_load_config(json.loads(str(z["overrides"])))
    names = {f.name for f in dataclasses.fields(Scenario)}
    fields = {k[len("scene/"):]: z[k] for k in z.files if k.startswith("scene/") and k[len("scene/"):] in names}
    return cfg, to_torch(Scenario(**fields), device), torch.as_tensor(z["ego_index"], device=device), z


def test_observation_replay_equals_the_full_width_golden():
    cfg, sc, ego, z = golden_scenario()
    assert sc.road_points.shape[1:] == (200, 100, 3) and sc.traj_position.shape[1] == 24
    obs, traj = observation_replay(cfg, sc, ego)
    want_obs = {k[len("obs/"):]: z[k] for k in z.files if k.startswith("obs/")}
    want_traj = {k[len("traj/"):]: z[k] for k in z.files if k.startswith("traj/")}
    _assert_streams(obs, want_obs, 1e-5)
    _assert_streams(traj, want_traj, 1e-4)
    assert obs["road_points"].shape == (10, 2, 300, 13) and obs["traffic_lights"].shape == (10, 2, 20, 12)
    assert float(obs["traffic_lights"][:, 1, :, 0].sum()) > 0 and not obs["traffic_lights"][:, 0].any()
