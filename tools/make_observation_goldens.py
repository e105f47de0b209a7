"""Write ``tests/goldens/reference_observation.npz``: the JAX package's
observation stream at full width, for the PyTorch port to be held against
without JAX (``tests/test_torch_gym.py`` on the CPU, ``chip_smoke.py``'s
observe-golden phase on the card).

Two synthetic scenes of the default config's widths (24 agent slots with
20 agents in a 120 m arena, so that objects and road points are occluded;
200 x 100 road points, a stop sign each), the second with 4 traffic lights
whose states change over the episode, are replayed through physics
(contacts off) by
``ctrl_sim_tpu.env.gym.observation_replay`` for 10 steps with the default
caps (16 objects, 20 lights, 300 road points, 4 stop signs, 80 m, 120
degrees), egos 0 and 3. The file holds the stacked scenes (``scene/<field>``),
the egos, the config overrides and every stream (``obs/<key>``,
``traj/<key>``), about 50 KB compressed. From the repo root:

    JAX_PLATFORMS=cpu python tools/make_observation_goldens.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ctrl_sim_tpu.config import load_config  # noqa: E402
from ctrl_sim_tpu.data import stack_scenarios, synthetic_scenario  # noqa: E402
from ctrl_sim_tpu.data.scenario import Scenario  # noqa: E402
from ctrl_sim_tpu.env.gym import observation_replay  # noqa: E402

OUT = os.path.join(ROOT, "tests", "goldens", "reference_observation.npz")
# contacts off: the dense scenes collide, and the contact solver orders an
# incident edge's tied corners by float32 rounding in the JAX package (a
# stated difference of the port, ROADMAP.md); the golden holds the
# observation, not the solver
OVERRIDES = {"sim.steps": 10, "sim.resolve_contacts": False}
EGOS = [0, 3]
SEEDS = [0, 1]


def scenes(cfg):
    """The two numpy scenes, the second with traffic lights near its ego."""
    out = [synthetic_scenario(cfg, seed=s, num_agents=20, arena_half=60.0) for s in SEEDS]
    lit = out[1]
    rng = np.random.default_rng(7)
    T1 = lit.traj_position.shape[1]
    ego = lit.traj_position[EGOS[1], 0]
    lit.tl_position = (ego[None] + rng.uniform(-60, 60, (4, 2))).astype(np.float32)
    lit.tl_state = np.repeat(rng.integers(0, 9, (4, 1 + T1 // 5)), 5, axis=1)[:, :T1].astype(np.int8)
    lit.tl_valid = np.ones(4, bool)
    return out


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    cfg = load_config(OVERRIDES)
    sb = stack_scenarios(scenes(cfg), cfg)
    d = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in dataclasses.asdict(sb).items()}
    d["name"] = ""
    obs, traj = jax.jit(lambda s, e: observation_replay(cfg, s, e))(Scenario(**d), jnp.asarray(EGOS, jnp.int32))
    arrays = {f"scene/{k}": v for k, v in dataclasses.asdict(sb).items() if isinstance(v, np.ndarray)}
    arrays.update({f"obs/{k}": np.asarray(v) for k, v in obs.items()})
    arrays.update({f"traj/{k}": np.asarray(v) for k, v in traj.items()})
    arrays["ego_index"] = np.asarray(EGOS, np.int32)
    arrays["overrides"] = np.asarray(json.dumps(OVERRIDES))
    np.savez_compressed(OUT, **arrays)
    vis = arrays["obs/road_points"][..., 0].sum(-1)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes); visible road points per step and scene "
          f"{vis.min():.0f}-{vis.max():.0f}, lights block non-zero: "
          f"{bool(arrays['obs/traffic_lights'][:, 1, :, 0].any())}")


if __name__ == "__main__":
    main()
