"""Shared set-up of the tests that hold the PyTorch port against the JAX
package: one toy configuration for both, scenes and params made once and
handed to each side as numpy arrays."""

from __future__ import annotations

import dataclasses
import os

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


# ---------------------------------------------------------------------------
# CTG++: the toy config of tests/test_ctg_golden.py, its executed-reference
# weights, and the JAX draws the port replays
# ---------------------------------------------------------------------------

CTG_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "reference_ctg.npz")

# hidden 32 / 2 heads, 2 trunk layers, 4 agents, horizon 3 + 3, 20 train and
# 10 eval diffusion steps, f32 (the golden's crops are 5 polylines x 6 points)
CTG_TOY = {
    "model.hidden_dim": 32,
    "model.num_heads": 2,
    "model.dim_feedforward": 64,
    "model.num_transformer_encoder_layers": 2,
    "model.compute_dtype": "float32",
    "model.n_diffusion_steps": 20,
    "model.n_eval_diffusion_step": 10,
    "model.use_rtg": False,
    "waymo.train_context_length": 6,
    "waymo.input_horizon": 3,
    "waymo.max_num_agents": 4,
    "waymo.rtg_discretization": 20,
    "waymo.max_num_road_polylines": 5,
    "waymo.max_num_road_pts_per_polyline": 6,
    "sim.max_agents": 4,
}


def ctg_configs(**extra):
    """The ``ctg_plus_plus`` preset with the CTG++ toy overrides (and not
    the CtRL-Sim ones), from the JAX package and from the port."""
    from ctrl_sim_tpu.config import _set_dotted as jax_set, preset as jax_preset
    from ctrl_sim_tpu_torch.config import _set_dotted as torch_set, preset as torch_preset

    jcfg, tcfg = jax_preset("ctg_plus_plus"), torch_preset("ctg_plus_plus")
    for key, value in {**CTG_TOY, **extra}.items():
        jcfg, tcfg = jax_set(jcfg, key, value), torch_set(tcfg, key, value)
    return jcfg, tcfg


def ctg_golden() -> dict:
    with np.load(CTG_GOLDEN) as g:
        return {k: g[k] for k in g.files}


def ctg_golden_cond(g: dict) -> dict:
    """The golden's conditioning as numpy arrays in the models' layout (the
    reference's per-agent timesteps [B, N, T, 1] hold one value: [B, T])."""
    return {
        "agent_past_states": g["in_agent_past_states"],
        "agent_past_actions": g["in_agent_past_actions"],
        "past_relative_encodings": g["in_agent_past_rel_encodings"],
        "future_relative_encodings": g["in_agent_future_rel_encodings"],
        "agent_types": g["in_agent_types"],
        "goals": g["in_goals"],
        "timesteps": g["in_timesteps"][:, 0, :, 0],
        "rtgs": g["in_rtgs"],
        "road_points": g["in_road_points"],
        "road_types": g["in_road_types"],
        "moving_agent_mask": g["in_moving_agent_masks"],
    }


def ctg_reference_state(g: dict, use_rtg: bool = False) -> dict:
    """A reference CTG++ Lightning state dict from the golden's weight
    dumps: the denoiser without RTG conditioning (``gd_w_``), or with it
    (``dit_w_``) beside the RTG head (``rtg_w_``)."""
    def take(pfx: str, to: str) -> dict:
        return {to + k[len(pfx):]: g[k] for k in g if k.startswith(pfx)}

    if use_rtg:
        return {**take("dit_w_", "diff_model.model."), **take("rtg_w_", "rtg_model.")}
    return take("gd_w_", "diff_model.model.")


def ctg_models(jcfg, tcfg, g: dict | None = None):
    """The JAX ``CTGPlusPlus`` with the executed reference's weights (its own
    importer), and the port's carrying the same weights through
    ``from_flax_params``."""
    from ctrl_sim_tpu.models.ctg_plus_plus import CTGPlusPlus as JaxCTG
    from ctrl_sim_tpu.utils.torch_import import ctg_params_from_torch_state as jax_ctg_params
    from ctrl_sim_tpu_torch.models.ctg_plus_plus import CTGPlusPlus

    g = ctg_golden() if g is None else g
    params = jax_ctg_params(ctg_reference_state(g, jcfg.model.use_rtg), jcfg)
    tm = CTGPlusPlus(tcfg, device="cpu")
    tm.load_state_dict(from_flax_params(jax.tree.map(np.asarray, params)), strict=True)
    tm.eval()
    return JaxCTG(jcfg), params, tm


def jax_loss_draws(key, shape: tuple, n_timesteps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The diffusion steps [B] and noise of the JAX ``GaussianDiffusion.loss``
    under ``key``."""
    k_t, k_noise = jax.random.split(key)
    t = jax.random.randint(k_t, (shape[0],), 0, n_timesteps)
    return torch.as_tensor(np.asarray(t)).long(), torch.as_tensor(np.asarray(jax.random.normal(k_noise, shape)))


def jax_sample_noise(key, shape: tuple, n_eval: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``GaussianDiffusion.sample``'s unit-normal draws under
    ``key`` as its ``noise_override``: (x0 noise, step noises [n_eval, ...])."""
    rng, k0 = jax.random.split(key)
    steps = []
    for _ in range(n_eval):
        rng, k = jax.random.split(rng)
        steps.append(np.asarray(jax.random.normal(k, shape)))
    return torch.as_tensor(np.asarray(jax.random.normal(k0, shape))), torch.as_tensor(np.stack(steps))


def jax_ctg_rollout_noise(jcfg, rng, shape: tuple) -> dict:
    """The sampler draws of every replan of the JAX ``run_ctg_closed_loop``
    under ``rng``, by step: its carry key is split once a step, and a
    replan at step t samples with ``fold_in(carry key, t)``."""
    from ctrl_sim_tpu_torch.rollout.ctg_rollout import replan_steps

    plans, out, key = set(replan_steps(jcfg)), {}, rng
    for t in range(jcfg.sim.steps):
        if t in plans:
            out[t] = jax_sample_noise(jax.random.fold_in(key, t), shape, jcfg.model.n_eval_diffusion_step)
        key, _ = jax.random.split(key)
    return out


# the CTG++ closed loop's toy: input horizon 10 (replans every 5 steps) + 3
# future steps, 20 steps with a history of 10 (replans at 9, 14, 19)
CTG_LOOP = {"waymo.input_horizon": 10, "waymo.train_context_length": 13, "sim.steps": 20,
            "sim.history_steps": 10, "sim.resolve_contacts": False}


def ctg_loop_setup(**extra):
    """(configs, 2 scenes of 4 agents, the JAX model and params, the port's
    model, the controlled mask) of the closed-loop toy."""
    jcfg, tcfg = ctg_configs(**{**CTG_LOOP, **extra})
    sb = scenes(jcfg, 2, num_agents=4)
    jm, params, tm = ctg_models(jcfg, tcfg)
    controlled = sb.moving & sb.agent_valid
    return jcfg, tcfg, sb, jm, params, tm, controlled


def replayed_ctg_rollouts(jcfg, tcfg, sb, jm, params, tm, controlled, seed: int = 2):
    """The JAX rollout under its key, and the port's under that key's draws."""
    from ctrl_sim_tpu.rollout.ctg_rollout import run_ctg_closed_loop as jax_run_ctg
    from ctrl_sim_tpu_torch.rollout.ctg_rollout import run_ctg_closed_loop

    key = jax.random.PRNGKey(seed)
    ro = jax.jit(lambda s, p, c, k: jax_run_ctg(jcfg, jm, p, s, c, k))(
        jax_scenario(sb), params, jnp.asarray(controlled), key)
    ro = jax.tree.map(np.asarray, ro)
    shape = (2, jcfg.waymo.max_num_agents, jcfg.waymo.train_context_length - jcfg.waymo.input_horizon, 7)
    noise = jax_ctg_rollout_noise(jcfg, key, shape)
    out = run_ctg_closed_loop(tcfg, tm, torch_scenario(sb), torch.as_tensor(controlled), None, noise=noise.get)
    return ro, out


def assert_ctg_rollouts_match(ro, out):
    """Every output stream of the two rollouts within 1e-4."""
    for name in ro._fields:
        np.testing.assert_allclose(t2n(getattr(out, name)).astype(np.float64),
                                   np.asarray(getattr(ro, name)).astype(np.float64), err_msg=name, atol=1e-4, rtol=1e-4)
