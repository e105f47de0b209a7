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
from ctrl_sim_tpu.rollout.streaming import run_streaming as jax_run_streaming
from ctrl_sim_tpu_torch.config import load_config as torch_load_config
from ctrl_sim_tpu_torch.data import to_torch
from ctrl_sim_tpu_torch.data import transforms as ttf
from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim as TorchCtRLSim
from ctrl_sim_tpu_torch.params import from_flax_params
from ctrl_sim_tpu_torch.rollout.streaming import run_streaming

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


def family_configs(family: str, **extra):
    """The preset of a model family ("ctrl_sim", "dt", "il", "trajeglish")
    with the toy overrides, from the JAX package and from the port."""
    from ctrl_sim_tpu.config import _set_dotted as jax_set, preset as jax_preset
    from ctrl_sim_tpu_torch.config import _set_dotted as torch_set, preset as torch_preset

    jcfg, tcfg = jax_preset(family), torch_preset(family)
    for key, value in {**TOY, **extra}.items():
        jcfg, tcfg = jax_set(jcfg, key, value), torch_set(tcfg, key, value)
    return jcfg, tcfg


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


def patch_jax_contact_tie_rule(monkeypatch):
    """Give the JAX package's contact geometry, for one test, the tie rule
    of the port's (ctrl_sim_tpu_torch/env/contacts.py, ``KEY_TIE``): the
    two corners of an incident edge project equally along its normal in
    exact arithmetic, and the JAX code orders them by float32 rounding,
    which differs between XLA's fusions and PyTorch; the port treats keys
    within ``KEY_TIE`` as equal and orders by corner index. With this one
    line changed in the JAX source (recompiled from its own text, nothing
    else copied), the two solvers can be held to float32 rounding."""
    import inspect

    from ctrl_sim_tpu.env import contacts as jcon
    from ctrl_sim_tpu_torch.env.contacts import KEY_TIE

    src = inspect.getsource(jcon._contact_geometry)
    old = (
        "    lt = (key[..., :, None] > key[..., None, :]) | (\n"
        "        (key[..., :, None] == key[..., None, :])\n"
        "        & (kidx[:, None] > kidx[None, :])\n"
        "    )"
    )
    new = (
        "    diff = key[..., :, None] - key[..., None, :]\n"
        "    lt = (diff > KEY_TIE) | ((jnp.abs(diff) <= KEY_TIE) & (kidx[:, None] > kidx[None, :]))"
    )
    assert src.count(old) == 1, "the JAX contact geometry changed: update this patch"
    namespace = {**vars(jcon), "KEY_TIE": KEY_TIE}
    exec(compile(src.replace(old, new), jcon.__file__, "exec"), namespace)
    monkeypatch.setattr(jcon, "_contact_geometry", namespace["_contact_geometry"])


STREAM_STEPS = 5


def stream_inputs(cfg, B: int, A: int, seed: int = 0) -> dict:
    """Numpy inputs of STREAM_STEPS steps of the streaming interface: map,
    states, goals, existence, applied actions and sampled RTG bins."""
    wc = cfg.waymo
    rng = np.random.default_rng(seed)
    P, L = wc.max_num_road_polylines, wc.max_num_road_pts_per_polyline
    road = rng.normal(size=(B, P, L, 3)).astype(np.float32) * 20
    road[..., 2] = rng.random((B, P, L)) > 0.2
    road[:, -2:] = 0.0  # empty polylines
    types12 = np.eye(5)[rng.integers(0, 5, size=(B, A))].astype(np.float32)
    states = rng.normal(size=(STREAM_STEPS, B, A, 12)).astype(np.float32)
    states[..., 7:] = types12
    exist = (rng.random((STREAM_STEPS, B, A)) > 0.15).astype(np.float32)
    return {
        "road_points": road,
        "road_types": np.eye(8)[rng.integers(0, 8, size=(B, P))].astype(np.float32),
        "states": states,
        "goals": rng.normal(size=(B, A, 5)).astype(np.float32),
        "exist": exist,
        "actions": rng.integers(0, wc.action_dim, size=(STREAM_STEPS, B, A)),
        "rtgs": rng.integers(0, wc.rtg_discretization, size=(STREAM_STEPS, B, A, 3)),
    }


def jax_stream(jcfg, jm, params, d: dict) -> dict:
    """The JAX model's memory, cross-attention K/V and STREAM_STEPS steps of
    both decode passes and both heads on one cache (jitted), the cache in
    the dtype the JAX rollout gives it (``model.kv_cache_dtype``)."""
    from ctrl_sim_tpu.models.decoder import KVCache as JaxKVCache

    mc, wc = jcfg.model, jcfg.waymo
    B, A = d["goals"].shape[:2]
    window = wc.train_context_length
    jd = {k: jnp.asarray(v) for k, v in d.items()}

    @jax.jit
    def memory(p, rp, rt, s0, g, e0):
        mem, valid = jm.apply(p, method=lambda m: m.encode_rollout_memory(
            rp, rt, s0, g, e0, jnp.asarray(0, jnp.int32)))
        return mem, valid, jm.apply(p, method=lambda m: m.precompute_memory_kv(mem))

    @jax.jit
    def step(p, pa, pe, s, g, e, r, t, cache, mem, valid, kv):
        def body(m):
            x, c = m.stream_action_state(pa, pe, s, g, e, t, cache, mem, valid, window, memory_kv=kv)
            y, c = m.stream_rtg(r, e, t, c, mem, valid, window, memory_kv=kv)
            return x, m.rtg_head(x), y, m.action_head(y), c
        return jm.apply(p, method=body)

    mem, valid, kv = memory(params, jd["road_points"], jd["road_types"], jd["states"][0], jd["goals"], jd["exist"][0])
    cache_dtype = jnp.int8 if mc.kv_cache_dtype == "int8" else jnp.dtype(mc.compute_dtype)
    cache = JaxKVCache.create(mc.num_decoder_layers, B, window, A, mc.num_token_types, mc.hidden_dim, cache_dtype)
    prev_a, prev_e = jnp.zeros((B, A), jnp.int32), jnp.zeros((B, A))
    per_step = []
    for t in range(STREAM_STEPS):
        *outs, cache = step(params, prev_a, prev_e, jd["states"][t], jd["goals"], jd["exist"][t],
                            jd["rtgs"][t], jnp.asarray(t, jnp.int32), cache, mem, valid, kv)
        per_step.append(outs)
        prev_a, prev_e = jd["actions"][t], jd["exist"][t]
    return {"memory": (mem, valid, kv), "steps": per_step, "cache": cache}


def torch_stream(tcfg, tm, d: dict, premask: bool = False) -> dict:
    """The port's counterpart of ``jax_stream``; ``premask`` feeds the
    rollout's precomputed per-step masks instead of the masks built from
    the ring labels."""
    from ctrl_sim_tpu_torch.ops.masks import stream_step_masks

    mc = tcfg.model
    B, A = d["goals"].shape[:2]
    T = torch.as_tensor
    with torch.no_grad():
        mem, valid = tm.encode_rollout_memory(
            T(d["road_points"]), T(d["road_types"]), T(d["states"][0]), T(d["goals"]), T(d["exist"][0]), 0)
        kv = tm.precompute_memory_kv(mem)
        cache = tm.new_cache(B, A)
        m1, m2 = stream_step_masks(STREAM_STEPS, tcfg.waymo.train_context_length, A, mc.num_token_types, 0,
                                   device="cpu")
        prev_a, prev_e = torch.zeros((B, A), dtype=torch.long), torch.zeros((B, A))
        per_step = []
        for t in range(STREAM_STEPS):
            x, cache = tm.stream_action_state(
                prev_a, prev_e, T(d["states"][t]), T(d["goals"]), T(d["exist"][t]), t, cache, valid, kv,
                mask_override=m1[t] if premask else None)
            y, cache = tm.stream_rtg(T(d["rtgs"][t]), T(d["exist"][t]), t, cache, valid, kv,
                                     mask_override=m2[t] if premask else None)
            per_step.append((x, tm.rtg_head(x), y, tm.action_head(y)))
            prev_a, prev_e = T(d["actions"][t]), T(d["exist"][t])
    return {"memory": (mem, valid, kv), "steps": per_step, "cache": cache}


class ReplaySampler:
    """Hands out given RTG bins [T, E, A, 3] (None: the policy samples no
    returns, and a call fails) and action ids [T, E, A], and keeps the
    logits it is given ([E, A, bins, 3] and [E, A, actions] a step)."""

    def __init__(self, rtg_bins, action_ids):
        self.rtg_bins, self.action_ids = rtg_bins, action_ids
        self.rtg_logits, self.action_logits = [], []

    def rtgs(self, t, logits, tilt):
        assert self.rtg_bins is not None, "this policy samples no returns"
        assert torch.isfinite(logits.float()).all()
        self.rtg_logits.append(t2n(logits.float()))
        return self.rtg_bins[t]

    def actions(self, t, logits):
        assert torch.isfinite(logits.float()).all()
        self.action_logits.append(t2n(logits.float()))
        return self.action_ids[t]


def replay_jax_rollout(jcfg, tcfg, sb, tm, params, jm, seed: int = 1, logits: dict | None = None):
    """The JAX ``run_streaming`` and the port's under its draws (recovered
    from its RTGs, where the policy samples them, and its controls), both
    from the same scenes and weights. With a ``logits`` dict, the logits
    each side draws from at every step go into it: the JAX side's under
    "jax_actions" / "jax_rtgs" (recorded by a host callback around its
    samplers), the port's under "actions" / "rtgs"."""
    from unittest import mock

    from ctrl_sim_tpu.rollout import streaming as jax_streaming

    controlled = sb.moving & sb.agent_valid
    tilt = jnp.asarray(np.random.default_rng(0).normal(size=(350, 3)).astype(np.float32))
    recorded = {"jax_actions": [], "jax_rtgs": []}

    def recording(sampler, key):
        def draw(rng, table_logits, *args):
            jax.debug.callback(lambda x: recorded[key].append(np.asarray(x)), table_logits, ordered=True)
            return sampler(rng, table_logits, *args)
        return draw

    with mock.patch.object(jax_streaming, "sample_actions", recording(jax_streaming.sample_actions, "jax_actions")), \
            mock.patch.object(jax_streaming, "sample_tilted_rtgs",
                              recording(jax_streaming.sample_tilted_rtgs, "jax_rtgs")):
        ro = jax.jit(lambda s, p, c, r, tl: jax_run_streaming(jcfg, jm, p, s, c, r, tl))(
            jax_scenario(sb), params, jnp.asarray(controlled), jax.random.PRNGKey(seed), tilt)
        ro = jax.tree.map(np.array, ro)
    wc = tcfg.waymo
    rtg_bins = None
    if tcfg.policy.predict_rtgs:
        rtg_bins = ttf.discretize_rtgs(ttf.normalize_rtgs(torch.as_tensor(ro.rtgs), wc), wc).long()
    action_ids = ttf.discretize_actions(
        torch.stack([torch.as_tensor(ro.acceleration), torch.as_tensor(ro.steering)], -1), wc).long()
    sampler = ReplaySampler(rtg_bins, action_ids)
    out = run_streaming(tcfg, tm, torch_scenario(sb), torch.as_tensor(controlled), torch.Generator(),
                        torch.tensor(np.asarray(tilt)), sampler=sampler)
    if logits is not None:
        logits.update(recorded, actions=sampler.action_logits, rtgs=sampler.rtg_logits)
    return ro, out
