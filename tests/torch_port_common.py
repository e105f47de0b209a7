"""Shared set-up of the tests that hold the PyTorch port against the JAX
package: one toy configuration for both, scenes and params made once and
handed to each side as numpy arrays."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ctrl_sim_tpu.config import load_config as jax_load_config
from ctrl_sim_tpu.data import stack_scenarios as jax_stack, synthetic_scenario as jax_synth
from ctrl_sim_tpu.data.scenario import Scenario as JaxScenario
from ctrl_sim_tpu.models.ctrl_sim import CtRLSim as JaxCtRLSim
from ctrl_sim_tpu_torch.config import load_config as torch_load_config
from ctrl_sim_tpu_torch.data import to_torch
from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim as TorchCtRLSim
from ctrl_sim_tpu_torch.params import from_flax_params

# hidden 64 / 4 heads (d = 16), 1 encoder + 2 decoder layers, 12 scene agents
# packed into 8 model slots, window 8, f32, contacts off
TOY = {
    "model.hidden_dim": 64,
    "model.num_heads": 4,
    "model.dim_feedforward": 128,
    "model.num_transformer_encoder_layers": 1,
    "model.num_decoder_layers": 2,
    "model.compute_dtype": "float32",
    "waymo.max_num_agents": 12,
    "waymo.train_context_length": 8,
    "waymo.max_num_road_polylines": 16,
    "waymo.max_num_road_pts_per_polyline": 20,
    "sim.max_agents": 12,
    "sim.steps": 16,
    "sim.history_steps": 4,
    "sim.resolve_contacts": False,
    "eval.agent_slots": 8,
}


def configs(**extra):
    """The same overrides applied to the JAX config and the port's."""
    over = {**TOY, **extra}
    return jax_load_config(over), torch_load_config(over)


def scenes(cfg, num_scenes: int = 4, num_agents: int = 8, seed0: int = 0):
    """Stacked numpy scenes from the JAX package's generator (the port's
    copy is held equal to it in test_torch_env.py)."""
    return jax_stack(
        [
            jax_synth(cfg, seed=seed0 + s, num_agents=num_agents, arena_half=60.0, num_lanes=2)
            for s in range(num_scenes)
        ],
        cfg,
    )


def jax_scenario(sb) -> JaxScenario:
    d = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in dataclasses.asdict(sb).items()}
    d["name"] = ""
    return JaxScenario(**d)


def torch_scenario(sb):
    """The JAX package's numpy scenes as the port's tensor scenario."""
    from ctrl_sim_tpu_torch.data.scenario import Scenario

    fields = {f.name for f in dataclasses.fields(Scenario)}
    return to_torch(Scenario(**{k: v for k, v in dataclasses.asdict(sb).items() if k in fields}), "cpu")


def init_batch(cfg, B: int = 1):
    wc = cfg.waymo
    A, T = wc.max_num_agents, wc.train_context_length
    P, L = wc.max_num_road_polylines, wc.max_num_road_pts_per_polyline
    return {
        "agent_states": jnp.zeros((B, A, T, 8)),
        "agent_types": jnp.zeros((B, A, 5)),
        "goals": jnp.zeros((B, A, 5)),
        "actions": jnp.zeros((B, A, T)),
        "rtgs": jnp.zeros((B, A, T, 3)),
        "timesteps": jnp.zeros((B, T), jnp.int32),
        "moving_agent_mask": jnp.ones((B, A)),
        "road_points": jnp.zeros((B, P, L, 3)),
        "road_types": jnp.zeros((B, P, 8)),
    }


def models(jcfg, tcfg, seed: int = 0):
    """The JAX model with params from ``model.init``, and the port's model
    carrying the same weights through ``from_flax_params``."""
    jm = JaxCtRLSim(jcfg)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(seed)}, init_batch(jcfg))
    tm = TorchCtRLSim(tcfg, device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)), strict=True)
    tm.eval()
    return jm, params, tm


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()
