"""CTG++ closed-loop rollout (port of ``ctrl_sim_tpu/rollout/ctg_rollout.py``;
reference policies/ctg_plus_plus_policy.py).

The diffusion policy plans at 2 Hz (every ``input_horizon // 2`` = 5 env
steps, policy_evaluator.py:511-527): at t = history_steps - 1 and every 5
steps after it, it builds the past-horizon conditioning from the live
buffers (per-agent local frames, relative encodings, per-agent road crops,
the transforms of the CTG++ training pipeline), samples a joint [state ||
action] future with the strided DDPM sampler and fills the action buffer
with the unnormalized (accel, steer) plan, which the controlled agents
follow between plans (:220-252). Uncontrolled agents log-replay through
physics. A Python loop over steps takes the place of ``lax.scan``.

Each replan draws from ``generator``; ``noise(t)``, where given, returns
the replan's whole noise stream (``GaussianDiffusion.sample``'s
``noise_override``) instead, so that a test can replay the draws of the
JAX key schedule. The sampler encodes the map and the edges once a replan.
"""

from __future__ import annotations

from typing import Callable

import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data.ctg_pipeline import (
    normalize_actions,
    past_conditioning,
    repeated_present_encodings,
    unnormalize_actions,
)
from ctrl_sim_tpu_torch.data.pipeline import goals_from_scenario
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.env.env import WaymoEnv
from ctrl_sim_tpu_torch.models.ctg.guidance import collision_guide, combine, goal_guide
from ctrl_sim_tpu_torch.rollout.rollout import (
    RolloutOutput,
    _recorded_state,
    applied_actions,
    finish_rollout,
    step_record,
)

Tensor = torch.Tensor
NoiseSource = Callable[[int], tuple[Tensor, Tensor]]


def replan_steps(cfg: Config) -> list[int]:
    """The steps at which the policy plans: history_steps - 1, then every
    ``input_horizon // 2``."""
    first, every = cfg.sim.history_steps - 1, cfg.waymo.input_horizon // 2
    return [t for t in range(cfg.sim.steps) if t >= first and (t - first) % every == 0]


def build_cond(cfg: Config, scenario: Scenario, states_buf: Tensor, actions_buf: Tensor, goals5: Tensor,
               types: Tensor, t: int) -> tuple[dict, Tensor]:
    """The conditioning of a replan at step t from the live buffers [E, A,
    S + 1, ...], and the anchor states [E, A, 8]."""
    wc = cfg.waymo
    T_in = wc.input_horizon
    E, A = types.shape[:2]
    w0 = max(t - (T_in - 1), 0)
    past, past_actions = states_buf[:, :, w0:w0 + T_in], actions_buf[:, :, w0:w0 + T_in]
    ctx = past_conditioning(cfg, past, goals5, scenario.road_points, scenario.road_types, scenario.road_valid)
    dev = states_buf.device
    cond = {
        "agent_past_states": ctx["agent_past_states"],
        "agent_past_actions": normalize_actions(past_actions, wc),
        "past_relative_encodings": ctx["past_relative_encodings"],
        "future_relative_encodings": repeated_present_encodings(
            ctx["past_relative_encodings"], wc.train_context_length - T_in),
        "agent_types": types,
        "goals": ctx["goals"],
        "timesteps": torch.full((E, wc.train_context_length), min(t, wc.max_timestep - 1), dtype=torch.int32,
                                device=dev),
        "rtgs": torch.zeros((E, A, T_in, 3), dtype=torch.int32, device=dev),
        "road_points": ctx["road_points"],
        "road_types": ctx["road_types"],
        "moving_agent_mask": torch.ones((E, A), device=dev),
    }
    return cond, ctx["anchor"]


def guidance(cfg: Config, anchor: Tensor):
    """The guidance cost ``policy.ctg_*_guidance`` asks for, or None."""
    pc = cfg.policy
    guides = []
    if pc.ctg_goal_guidance > 0.0:
        guides.append(goal_guide(pc.ctg_goal_guidance))
    if pc.ctg_collision_guidance > 0.0:
        guides.append(collision_guide(anchor, cfg.waymo.pos_div, radius=pc.ctg_collision_radius,
                                      weight=pc.ctg_collision_guidance))
    return combine(*guides) if guides else None


@torch.no_grad()
def run_ctg_closed_loop(
    cfg: Config,
    model,  # models.ctg_plus_plus.CTGPlusPlus
    scenario: Scenario,  # tensors on the model's device (data.to_torch)
    controlled_mask: Tensor,  # [E, A] bool
    generator: torch.Generator | None,
    noise: NoiseSource | None = None,
) -> RolloutOutput:
    """CTG++ rollout of ``cfg.sim.steps`` steps over lanes of exactly
    ``waymo.max_num_agents`` agent slots (no focal groups, no tilt). Runs
    under ``no_grad`` (guidance takes its gradients inside)."""
    wc = cfg.waymo
    env = WaymoEnv(cfg)
    steps, T_in, A = cfg.sim.steps, wc.input_horizon, wc.max_num_agents
    tp = scenario.traj_position
    E, dev = tp.shape[0], tp.device
    if tp.shape[1] != A:
        raise ValueError("lanes must have exactly max_num_agents slots")
    T_out = wc.train_context_length - T_in
    tgt_k = wc.k_attr - 2
    plans = set(replan_steps(cfg))

    goals5 = goals_from_scenario(scenario)
    types = torch.nn.functional.one_hot(scenario.agent_type.long(), wc.num_agent_types).float()
    env_state = env.reset(scenario)
    states_buf = torch.zeros((E, A, steps + 1, 8), device=dev)
    actions_buf = torch.zeros((E, A, steps + 1, 2), device=dev)
    plan_buf = torch.zeros((E, A, T_out, 2), device=dev)
    plan_step = 0
    zeros3 = torch.zeros((E, A, 3), device=dev)
    rows = []
    for t in range(steps):
        reward8, env_state = env.reward(scenario, env_state)
        states_buf[:, :, t] = _recorded_state(env_state, scenario.length, scenario.width)
        if t in plans:
            cond, anchor = build_cond(cfg, scenario, states_buf, actions_buf, goals5, types, t)
            samples = model.sample_from_cond(cond, generator, guidance_fn=guidance(cfg, anchor),
                                             noise_override=noise(t) if noise is not None else None)
            plan_buf, plan_step = unnormalize_actions(samples[..., tgt_k:], wc), t
        planned = plan_buf[:, :, min(max(t - plan_step, 0), T_out - 1)]
        accel, steer, alive_next = applied_actions(cfg, scenario, env_state, t, controlled_mask, planned)
        rows.append(step_record(env_state, reward8, accel, steer, zeros3))
        env_state = env.step(scenario, env_state, accel, steer, expert_mask=torch.zeros_like(alive_next),
                             alive_next=alive_next)
        actions_buf[:, :, t] = torch.stack([accel, steer], dim=-1)
    return finish_rollout(env, scenario, env_state, rows, controlled_mask)
