"""Closed-loop rollouts (port of ``ctrl_sim_tpu/rollout/rollout.py``): the
exact-mode rollout ``run_closed_loop``, the outputs and the helpers it
shares with the streaming rollout (``rollout/streaming.py``).

Per env step of ``run_closed_loop``, for every lane (scene) at once:

  record the pre-step state and reward -> the 32-step sliding window of the
  recorded states, applied actions and RTGs -> per focal group: re-elect
  the origin, shrink the sticky relevant set by 60 m from the origin at the
  window anchor, repack the slots in original-index order, normalize the
  window in the origin's frame at its anchor -> the full model forward over
  every (scene, group) crop (tilted RTG sampling with cross-group dedup) ->
  a second forward with the sampled RTG bins written in (action sampling)
  -> controlled agents act after the history window, the others replay GT
  through inverse-bicycle actions -> FreeCar step, collisions.

Every decode is a whole forward of the training model over the window
(``CtRLSim.forward``), so its decoder self-attention runs the flash
attention forward, kernel K3, on the card: 2 forwards x layers per step
where the policy samples returns, one otherwise. It is the reference-parity
path (policy_evaluator.py:514-542). A Python loop over steps takes the place
of ``lax.scan``; the buffers are written in place. Semantics kept from the
JAX package, with its documented deviation: a controlled vehicle outside
every living group coasts (zero action through physics).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data import transforms as tf
from ctrl_sim_tpu_torch.data.pipeline import goals_from_scenario
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.env.dynamics import inverse_bicycle_action
from ctrl_sim_tpu_torch.env.env import EnvState, WaymoEnv
from ctrl_sim_tpu_torch.geometry import signed_distance_to_polylines
from ctrl_sim_tpu_torch.rollout.groups import (
    GroupSpec,
    gather_members,
    packed_trivial_groups,
    scatter_by_rank,
    trivial_groups,
)
from ctrl_sim_tpu_torch.rollout.policy import PolicySampler

Tensor = torch.Tensor


class RolloutOutput(NamedTuple):
    """Stacked per-step streams, time-major [T(+1), E, A, ...]."""

    position: Tensor
    velocity: Tensor
    heading: Tensor
    speed: Tensor
    existence: Tensor
    reward8: Tensor
    acceleration: Tensor  # [T, E, A]
    steering: Tensor
    nearest_dist: Tensor  # [T+1, E, A]
    rtgs: Tensor  # [T, E, A, 3] continuous sampled RTGs
    controlled_mask: Tensor  # [E, A]


def _recorded_state(env_state: EnvState, length: Tensor, width: Tensor) -> Tensor:
    """(x, y, vx, vy, yaw, L, W, existence) [E, A, 8] from the env state,
    the Policy.update_state layout (policies/policy.py:68-79)."""
    b = env_state.bodies
    return torch.cat(
        [b.position, b.velocity, b.heading[..., None], length[..., None], width[..., None],
         env_state.alive[..., None].to(b.position.dtype)],
        dim=-1,
    )


def _nearest_dist(position: Tensor, existence: Tensor) -> Tensor:
    """Unclipped nearest-vehicle distance at one timestep [E, A]
    (evaluator.py:87-103)."""
    return tf.compute_dist_to_nearest_vehicle(position, existence)


def dt_dense_reward3(cfg: Config, scenario: Scenario, env_state: EnvState, reward8: Tensor) -> Tensor:
    """Per-step dense 3-component reward of the DT policy's real-time RTG
    decay (evaluator.py:106-140): goal achieved, shaped nearest-vehicle
    distance minus collision, shaped road-edge distance minus collision."""
    wc = cfg.waymo
    ex_now = env_state.alive.float()
    nearest_now = _nearest_dist(env_state.bodies.position, ex_now)
    veh_dist = (nearest_now * ex_now).clamp(0.0, wc.max_veh_veh_distance) / wc.max_veh_veh_distance
    signed = signed_distance_to_polylines(
        env_state.bodies.position, scenario.edge_polylines, scenario.edge_poly_valid
    )
    dense_goal = reward8[..., 0] * wc.pos_target_achieved_rew_multiplier
    dense_veh = veh_dist - reward8[..., 6] * wc.veh_veh_collision_rew_multiplier
    dense_edge = (
        signed.abs().clamp(0.0, 5.0) / 5.0
        - reward8[..., 7] * wc.veh_edge_collision_rew_multiplier
    )
    return torch.stack([dense_goal, dense_veh, dense_edge], dim=-1) * ex_now[..., None]


def initial_real_time_rtgs(cfg: Config, controlled_mask: Tensor) -> Tensor:
    """The DT policy's real-time returns at t = 0 (policy_evaluator.py:
    123-145), [E, A, 3]: the largest achievable (10, 90, 90), or (0, -10,
    -10) for the evaluated vehicles under ``policy.min_return``."""
    dev = controlled_mask.device
    rtg = torch.tensor([10.0, 90.0, 90.0], device=dev).expand(controlled_mask.shape + (3,))
    if cfg.policy.min_return:
        rtg = torch.where(controlled_mask[..., None], torch.tensor([0.0, -10.0, -10.0], device=dev), rtg)
    return rtg


def agent_tilts(cfg: Config, controlled_mask: Tensor, tilt_logits: Tensor | None) -> Tensor:
    """Tilt logits per agent [E, A, bins, 3]: ``tilt_logits`` [bins, 3] on
    the controlled agents and zero elsewhere, or given per agent (the
    planner-vs-adversary evaluator tilts ego and adversary apart)."""
    if tilt_logits is None:
        tilt_logits = torch.zeros((cfg.waymo.rtg_discretization, 3), device=controlled_mask.device)
    if tilt_logits.dim() == 2:
        return torch.where(controlled_mask[..., None, None], tilt_logits, 0.0)
    return tilt_logits


def applied_actions(
    cfg: Config, scenario: Scenario, env_state: EnvState, t: int, controlled_mask: Tensor,
    policy_actions: Tensor,  # [E, A, 2]
) -> tuple[Tensor, Tensor, Tensor]:
    """(accel, steer, alive_next) of step t: the policy's action for a live
    controlled agent from ``history_steps - 1`` on (policy_evaluator.py:534),
    the inverse-bicycle action toward the next GT pose for every other
    agent (zero where that pose or the current one is missing,
    evaluator.py:160-193); replay agents die one step early."""
    tp, th, ts, tv = (scenario.traj_position, scenario.traj_heading, scenario.traj_speed,
                      scenario.traj_valid)
    bodies = env_state.bodies
    gt_accel, gt_steer = inverse_bicycle_action(
        tp[:, :, t + 1], th[:, :, t + 1], ts[:, :, t + 1],
        bodies.position, bodies.heading, bodies.speed, scenario.length, cfg.sim.dt,
    )
    replay_valid = env_state.alive & tv[:, :, t] & tv[:, :, t + 1]
    gt_accel = torch.where(replay_valid, gt_accel, 0.0)
    gt_steer = torch.where(replay_valid, gt_steer, 0.0)
    use_policy = controlled_mask & env_state.alive & (t >= cfg.sim.history_steps - 1)
    accel = torch.where(use_policy, policy_actions[..., 0], gt_accel)
    steer = torch.where(use_policy, policy_actions[..., 1], gt_steer)
    alive_next = env_state.alive & tv[:, :, t + 1] & (use_policy | replay_valid)
    return accel, steer, alive_next


def step_record(env_state: EnvState, reward8: Tensor, accel: Tensor, steer: Tensor,
                rtg_cont: Tensor) -> tuple:
    """One step's row of the output streams, from the pre-step state."""
    bodies, exist = env_state.bodies, env_state.alive.float()
    return (bodies.position, bodies.velocity, bodies.heading, bodies.speed, exist, reward8,
            accel, steer, _nearest_dist(bodies.position, exist), rtg_cont)


def finish_rollout(env: WaymoEnv, scenario: Scenario, env_state: EnvState, rows: list,
                   controlled_mask: Tensor) -> RolloutOutput:
    """The stacked streams, with the final state's record appended to the
    [T+1] streams (policy_evaluator.py:544-556)."""
    final_reward8, final = env.reward(scenario, env_state)
    cols = list(zip(*rows))
    exist = final.alive.float()
    last = (final.bodies.position, final.bodies.velocity, final.bodies.heading,
            final.bodies.speed, exist, final_reward8)
    stacked = [torch.stack(list(c) + [x]) for c, x in zip(cols[:6], last)]
    return RolloutOutput(
        *stacked,
        acceleration=torch.stack(cols[6]),
        steering=torch.stack(cols[7]),
        nearest_dist=torch.stack(list(cols[8]) + [_nearest_dist(final.bodies.position, exist)]),
        rtgs=torch.stack(cols[9]),
        controlled_mask=controlled_mask,
    )


def select_focal_agents(scenario: Scenario, controlled_mask: Tensor) -> Tensor:
    """Origin agent per lane: the controlled vehicle with the longest GT
    existence (autoregressive_policy.py:88-94); ties go to the lowest index."""
    lengths = scenario.traj_valid.sum(dim=2)
    keyed = torch.where(controlled_mask, lengths, -1)
    return torch.argmax(keyed, dim=1)


def default_groups(
    cfg: Config,
    scenario: Scenario,
    controlled_mask: Tensor,
    crop_size: int | None = None,
) -> GroupSpec:
    """Single-group spec for scenes already at the crop size; ``crop_size``
    below the scene's agent count packs the crop_size closest in-range
    agents into the leading model slots (groups.packed_trivial_groups)."""
    wc = cfg.waymo
    tp = scenario.traj_position
    if crop_size is None and tp.shape[1] != wc.max_num_agents:
        raise ValueError(
            f"scenes with {tp.shape[1]} agent slots need focal groups or packed "
            f"slots: max_num_agents={wc.max_num_agents}"
        )
    origin_idx = select_focal_agents(scenario, controlled_mask)
    pos0 = tp[:, :, 0]
    origin_pos0 = torch.gather(pos0, 1, origin_idx[:, None, None].expand(-1, 1, 2))
    dist0 = torch.linalg.vector_norm(pos0 - origin_pos0, dim=-1)
    relevant0 = (
        (dist0 < wc.agent_dist_threshold) & scenario.agent_valid & scenario.traj_valid[:, :, 0]
    )
    gt_length = scenario.traj_valid.sum(dim=2)
    if crop_size is not None and crop_size != tp.shape[1]:
        return packed_trivial_groups(
            cfg, origin_idx, relevant0, controlled_mask, gt_length, dist0, crop_size
        )
    return trivial_groups(cfg, origin_idx, relevant0, controlled_mask, gt_length)


@torch.inference_mode()
def run_closed_loop(
    cfg: Config,
    model,
    scenario: Scenario,  # tensors on the model's device (data.to_torch)
    controlled_mask: Tensor,  # [E, A] bool
    generator: torch.Generator | None,
    tilt_logits: Tensor | None = None,  # [bins, 3] or [E, A, bins, 3]
    groups: GroupSpec | None = None,
    sampler=None,
) -> RolloutOutput:
    """Exact-mode rollout of ``cfg.sim.steps`` steps: the sliding window is
    re-normalized and the whole token sequence re-decoded every step.
    ``groups`` are the focal groups (``groups.build_focal_groups``; by
    default one group of the scene, which must then have
    ``waymo.max_num_agents`` agent slots). ``sampler`` replaces the
    ``PolicySampler`` drawing from ``generator`` (tests replay given draws
    through it)."""
    wc, pc = cfg.waymo, cfg.policy
    env = WaymoEnv(cfg)
    sampler = sampler if sampler is not None else PolicySampler(cfg, generator)
    steps, T_ctx, Am = cfg.sim.steps, wc.train_context_length, wc.max_num_agents
    if steps + 1 < T_ctx:
        raise ValueError(f"sim.steps + 1 = {steps + 1} is shorter than the window {T_ctx}")
    if groups is None:
        groups = default_groups(cfg, scenario, controlled_mask)
    if groups.crop_size != Am:
        raise ValueError(f"group crop size {groups.crop_size} must equal waymo.max_num_agents {Am}")
    G, members = groups.num_groups, groups.members

    tp = scenario.traj_position
    length, width = scenario.length, scenario.width
    E, A = tp.shape[:2]
    EG, dev = E * G, tp.device

    def eg(x: Tensor) -> Tensor:
        """[E, G, Am, ...] -> [EG, Am, ...]"""
        return x.reshape((EG,) + x.shape[2:])

    def bcast_groups(x: Tensor) -> Tensor:  # static per-scene road data [E, P, ...] -> [EG, P, ...]
        return x[:, None].expand((E, G) + x.shape[1:]).reshape((EG,) + x.shape[1:])

    goals5 = goals_from_scenario(scenario)
    types = torch.nn.functional.one_hot(scenario.agent_type.long(), wc.num_agent_types).float()
    agent_tilt = agent_tilts(cfg, controlled_mask, tilt_logits)
    roads = [bcast_groups(x) for x in (scenario.road_points, scenario.road_types, scenario.road_valid)]

    env_state = env.reset(scenario)
    rtg_rt = initial_real_time_rtgs(cfg, controlled_mask)
    states_buf = torch.zeros((E, A, steps + 1, 8), device=dev)
    actions_buf = torch.zeros((E, A, steps + 1, 2), device=dev)
    rtgs_buf = torch.zeros((E, A, steps + 1, 3), device=dev)
    relevant = groups.member_valid  # sticky membership, shrinks with distance
    slot_ar = torch.arange(Am, device=dev)
    rows = []
    for t in range(steps):
        # ---- record the pre-step state and reward (policy_evaluator.py:515)
        reward8, env_state = env.reward(scenario, env_state)
        states_buf[:, :, t] = _recorded_state(env_state, length, width)
        if pc.real_time_rewards:
            # DT: the buffer carries the real-time return, decayed after it
            # is written (policy_evaluator.py:146-149)
            rtgs_buf[:, :, t] = rtg_rt
            rtg_rt = rtg_rt - dt_dense_reward3(cfg, scenario, env_state, reward8)
        if t == 0:  # moving from episode start (autoregressive_policy.py:52-53)
            moving = torch.linalg.vector_norm(states_buf[:, :, 0, :2] - goals5[..., :2], dim=-1) \
                > wc.moving_threshold

        # ---- the window [w0, w0 + T_ctx) (dynamic_slice_in_dim) --------------
        w0 = max(t - (T_ctx - 1), 0)
        token_index = min(t, T_ctx - 1)
        win_states, win_actions, win_rtgs = (x[:, :, w0:w0 + T_ctx] for x in (states_buf, actions_buf, rtgs_buf))

        # ---- per-group origin (re-)election: the longest-lived alive assigned
        # vehicle (autoregressive_policy.py:88-105); torch.argmax takes the
        # first maximum, as jnp.argmax does
        alive_slot = gather_members(env_state.alive, members)
        len_slot = gather_members(groups.gt_length, members)
        okey = torch.where(groups.assigned & alive_slot & relevant, len_slot, -1.0)
        origin_slot_m = torch.argmax(okey, dim=2)  # [E, G], members space
        group_alive = (okey.amax(dim=2) >= 0) & groups.group_valid

        # ---- sticky 60 m shrink from the origin at the window anchor ----------
        anchor_slot = gather_members(win_states[:, :, 0, :2], members)  # [E, G, Am, 2]
        origin_anchor = torch.gather(anchor_slot, 2, origin_slot_m[..., None, None].expand(E, G, 1, 2))
        dist = torch.linalg.vector_norm(anchor_slot - origin_anchor, dim=-1)
        relevant = relevant & (dist < wc.agent_dist_threshold)

        # ---- repack: the remaining members first, in original-index order
        # (the keys are distinct; stable only guards a later change)
        order = torch.argsort(torch.where(relevant, slot_ar, Am + slot_ar), dim=2, stable=True)
        gidx = torch.gather(members, 2, order)  # [E, G, Am]
        slot_valid = torch.gather(relevant, 2, order)
        origin_slot = (order == origin_slot_m[..., None]).int().argmax(dim=2)

        def g(x: Tensor) -> Tensor:
            out = gather_members(x, gidx)
            return out * slot_valid.reshape(slot_valid.shape + (1,) * (out.dim() - 3)).to(out.dtype)

        s_rtgs = tf.normalize_rtgs(g(win_rtgs), wc)
        d_rtgs = tf.discretize_rtgs(s_rtgs, wc) if pc.discretize_rtgs else s_rtgs
        s_types = torch.where(slot_valid[..., None], gather_members(types, gidx), -1.0)
        s_moving = gather_members(moving, gidx) & slot_valid
        # each (scene, group) lane in its origin's frame at the window anchor
        norm = tf.normalize_scene(eg(g(win_states)), *roads, eg(g(goals5)), origin_slot.reshape(EG), wc)
        batch = {
            "agent_states": norm.agent_states,
            "agent_types": eg(s_types),
            "goals": norm.goals,
            "actions": eg(tf.discretize_actions(g(win_actions), wc)),
            "rtgs": eg(d_rtgs),
            "timesteps": (w0 + torch.arange(T_ctx, device=dev)).expand(EG, T_ctx),
            "moving_agent_mask": eg(s_moving).float(),
            "road_points": norm.road_points,
            "road_types": norm.road_types,
        }
        contrib = slot_valid & group_alive[..., None]

        # ---- pass 1: RTG logits, cross-group dedup, tilted sampling ----------
        if pc.predict_rtgs:
            rtg_logits = model(batch, deterministic=True).rtg_preds[:, :, token_index]
            rtg_logits = rtg_logits.reshape(E, G, Am, wc.rtg_discretization, 3)
            # each agent's logits come from the lowest-rank group containing it
            table_logits, covered = scatter_by_rank(rtg_logits, gidx, contrib, A)
            rtg_bins = sampler.rtgs(t, table_logits, agent_tilt)  # tilt by agent id
            rtg_cont = tf.undiscretize_rtgs(rtg_bins, wc) * covered[..., None]
            # the shared bins go into every group's input at the current token
            # (autoregressive_policy.py:185-207)
            bins_slot = gather_members(rtg_bins, gidx) * slot_valid[..., None]
            batch["rtgs"] = batch["rtgs"].clone()
            batch["rtgs"][:, :, token_index] = eg(bins_slot).to(batch["rtgs"].dtype)
        else:
            rtg_cont = torch.zeros((E, A, 3), device=dev)

        # ---- pass 2: action sampling from the agent's winning group ----------
        logits = model(batch, deterministic=True).action_preds[:, :, token_index].reshape(E, G, Am, -1)
        table_action_logits, act_covered = scatter_by_rank(logits, gidx, contrib, A)
        action_ids = sampler.actions(t, table_action_logits)
        # a controlled agent outside every living group coasts
        policy_actions = tf.undiscretize_actions(action_ids, wc) * act_covered[..., None]

        accel, steer, alive_next = applied_actions(cfg, scenario, env_state, t, controlled_mask, policy_actions)
        rows.append(step_record(env_state, reward8, accel, steer, rtg_cont))
        env_state = env.step(
            scenario, env_state, accel, steer,
            expert_mask=torch.zeros_like(alive_next), alive_next=alive_next,
        )
        actions_buf[:, :, t] = torch.stack([accel, steer], dim=-1)
        if pc.predict_rtgs:  # DT wrote its real-time return above; IL and trajeglish keep zeros
            rtgs_buf[:, :, t] = rtg_cont

    return finish_rollout(env, scenario, env_state, rows, controlled_mask)
