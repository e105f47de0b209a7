"""Convert the committed orbax checkpoints into the PyTorch port's layout.

Restores three checkpoints of the JAX package (``artifacts/r05/ckpt_s0``
and ``ckpt_s1`` at step 26000, ``artifacts/ckpt_c`` at step 5000), each with
the config it was trained under (its ``config.json``), the way
``examples/tilt_control.py`` restores them, and writes for each:

- ``artifacts/torch/<name>/step_<n>.pt``: what the port's
  ``training/checkpoint.py`` saves, the step, the model's ``state_dict``
  (the flax params through ``ctrl_sim_tpu_torch/params.py:from_flax_params``)
  and the ``torch.optim.AdamW`` state over the port's two parameter groups,
  with optax's AdamW moments mapped the same way: ``mu`` to ``exp_avg``,
  ``nu`` to ``exp_avg_sq``, ``count`` to ``step``;
- ``artifacts/torch/<name>/config.json``: the port's config with the
  checkpoint's shapes (its ``model.kv_cache_dtype`` is the JAX config's).

Needs JAX, flax, optax and orbax, so it runs where the JAX package does;
the port reads only its output. From the repo root:

    JAX_PLATFORMS=cpu python tools/convert_checkpoints_to_torch.py
"""

from __future__ import annotations

import json
import os
import sys

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CHECKPOINTS = {  # name: (orbax directory, step)
    "r05_s0": (os.path.join(REPO, "artifacts", "r05", "ckpt_s0"), 26000),
    "r05_s1": (os.path.join(REPO, "artifacts", "r05", "ckpt_s1"), 26000),
    "ckpt_c": (os.path.join(REPO, "artifacts", "ckpt_c"), 5000),
}
OUT = os.path.join(REPO, "artifacts", "torch")


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def overrides(directory: str) -> dict:
    """The checkpoint's config.json as dotted overrides, every field."""
    with open(os.path.join(directory, "config.json")) as f:
        return _flatten(json.load(f))


def template_batch(cfg) -> dict:
    """A model batch of zeros: what ``Trainer.init_state`` needs to trace
    the param and optimizer trees that orbax restores into."""
    import jax.numpy as jnp

    wc = cfg.waymo
    A, T = wc.max_num_agents, wc.train_context_length
    P, L = wc.max_num_road_polylines, wc.max_num_road_pts_per_polyline
    return {
        "agent_states": jnp.zeros((1, A, T, 8)), "agent_types": jnp.zeros((1, A, 5)),
        "goals": jnp.zeros((1, A, 5)), "actions": jnp.zeros((1, A, T)), "rtgs": jnp.zeros((1, A, T, 3)),
        "timesteps": jnp.zeros((1, T), jnp.int32), "moving_agent_mask": jnp.ones((1, A)),
        "road_points": jnp.zeros((1, P, L, 3)), "road_types": jnp.zeros((1, P, 8)),
    }


def restore_jax(directory: str, step: int):
    """(JAX config, restored TrainState as numpy) of an orbax checkpoint."""
    from ctrl_sim_tpu.config import load_config
    from ctrl_sim_tpu.training import Trainer
    from ctrl_sim_tpu.training.checkpoint import CheckpointManager

    cfg = load_config(overrides(directory))
    # the trees' shapes only (no weights are initialized), which orbax fills
    template = jax.eval_shape(lambda k, b: Trainer(cfg).init_state(k, b), jax.random.PRNGKey(0), template_batch(cfg))
    state = CheckpointManager(cfg, directory).restore(template, step=step)
    return cfg, jax.tree.map(np.asarray, state)


def adam_state(opt_state):
    """optax's ``ScaleByAdamState`` (count, mu, nu) inside the chain of
    ``ctrl_sim_tpu/training/trainer.py:make_optimizer``."""
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(s, "nu")]
    if len(found) != 1:
        raise ValueError(f"expected one AdamW state in the optimizer state, found {len(found)}")
    return found[0]


def torch_checkpoint(directory: str, step: int):
    """The port's (config, checkpoint dict) of an orbax checkpoint."""
    from ctrl_sim_tpu_torch.config import config_from_dict
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.params import from_flax_params
    from ctrl_sim_tpu_torch.training.trainer import make_optimizer

    _, state = restore_jax(directory, step)
    if int(state.step) != step:
        raise ValueError(f"{directory}: restored step {int(state.step)}, expected {step}")
    with open(os.path.join(directory, "config.json")) as f:
        cfg = config_from_dict(json.load(f))
    model = CtRLSim(cfg, device="cpu")
    model.load_state_dict(from_flax_params(state.params), strict=True)
    opt = make_optimizer(cfg, model)
    adam = adam_state(state.opt_state)
    count = int(np.asarray(adam.count))
    mu, nu = from_flax_params(adam.mu), from_flax_params(adam.nu)
    for name, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": mu[name].clone(),
                        "exp_avg_sq": nu[name].clone()}
    return cfg, {"step": int(state.step), "model": model.state_dict(), "optimizer": opt.state_dict()}


def main() -> None:
    for name, (directory, step) in CHECKPOINTS.items():
        cfg, ckpt = torch_checkpoint(directory, step)
        out = os.path.join(OUT, name)
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"step_{step}.pt")
        torch.save(ckpt, path)
        with open(os.path.join(out, "config.json"), "w") as f:
            f.write(cfg.to_json())
        print(f"{directory} step {step} -> {path} ({os.path.getsize(path)} bytes)", flush=True)


if __name__ == "__main__":
    main()
