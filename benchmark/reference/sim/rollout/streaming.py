"""Streaming closed-loop rollout with incremental KV-cached decoding
(port of ``ctrl_sim_tpu/rollout/streaming.py:run_streaming``).

Per env step, for every (scene, group) lane at once:

  env reward -> normalize the slots' states in the lane's fixed frame ->
  the family's decode passes -> action sampling -> controlled agents act
  after the history window, the others replay GT through inverse-bicycle
  actions -> FreeCar step, collisions.

The decode passes of each family (every one writes the previous step's
action tokens into the cache first; their outputs are unused):

- CtRL-Sim, fused (``eval.streaming_passes`` < 3): pass 1, the t-1 action
  tokens + the t state tokens (``stream_action_state``) -> tilted RTG
  sampling -> pass 2, the t RTG tokens (``stream_rtg``), whose rows feed
  the action head. Both passes' [Q, N] masks are precomputed for every step
  (ops/masks.py:stream_step_masks).
- CtRL-Sim, sequential (``eval.streaming_passes=3``): the t-1 actions, the
  t states, the t RTGs, each in a pass of its own.
- DT: one pass of the t-1 actions, the t RTG tokens (the real-time returns,
  decayed by ``dt_dense_reward3`` after they are embedded) and the t state
  tokens, whose rows feed the action head;
- IL: one pass of the t-1 actions and the t states;
- trajeglish: one pass of the t-1 actions and a zero-action probe at t,
  whose rows predict this step's action.

The masks of the one-pass families and of the 3-pass decode are built
each pass from the ring's slot labels (``Decoder._mask``). The frame is anchored at the origin agent's pose at
episode start, and the memory (map + initial states) and its
cross-attention K/V are computed once per episode. A Python loop over
steps takes the place of ``lax.scan``; the KV ring cache is updated in
place. The cache is int8 with per-token scales when
``model.kv_cache_dtype`` is "int8" (kernel K2), else in the compute dtype
(kernel K1).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.sim.config import Config
from benchmark.reference.sim.data import transforms as tf
from benchmark.reference.sim.data.pipeline import goals_from_scenario
from benchmark.reference.sim.data.scenario import Scenario
from benchmark.reference.sim.env.env import WaymoEnv
from benchmark.reference.sim.geometry import angle_sub, apply_se2
from benchmark.reference.sim.ops.masks import stream_step_masks
from benchmark.reference.sim.rollout.groups import GroupSpec, gather_members, scatter_by_rank
from benchmark.reference.sim.rollout.policy import PolicySampler
from benchmark.reference.sim.rollout.rollout import (
    RolloutOutput,
    agent_tilts,
    applied_actions,
    default_groups,
    dt_dense_reward3,
    finish_rollout,
    initial_real_time_rtgs,
    step_record,
)

Tensor = torch.Tensor


def _frame(origin_pos: Tensor, origin_yaw: Tensor) -> tuple[Tensor, Tensor]:
    """normalize_scene's frame (dataset.py:390-394): rotate by
    pi/2 + sign(-yaw)*|yaw| about the origin agent's position."""
    return origin_pos, (math.pi / 2) + torch.sign(-origin_yaw) * origin_yaw.abs()


def _normalize_states(frame, position: Tensor, velocity: Tensor, heading: Tensor):
    """Positions, velocities and headings [EG, Am, ...] in each lane's frame,
    headings stored negated as the reference does (angle_sub(h, -rot),
    dataset.py:403)."""
    translation, rotation = frame
    pos = apply_se2(position, translation[:, None, :], rotation)
    vel = apply_se2(velocity, torch.zeros_like(translation)[:, None, :], rotation)
    return pos, vel, angle_sub(heading, -rotation[:, None])


@torch.no_grad()
def run_streaming(
    cfg: Config,
    model,
    scenario: Scenario,  # tensors on the model's device (data.to_torch)
    controlled_mask: Tensor,  # [E, A] bool
    generator: torch.Generator,
    tilt_logits: Tensor | None = None,  # [bins, 3] or [E, A, bins, 3]
    groups: GroupSpec | None = None,
    sampler=None,
) -> RolloutOutput:
    """Closed-loop rollout of ``cfg.sim.steps`` steps. ``sampler`` replaces
    the ``PolicySampler`` drawing from ``generator``; the reference's copy
    hands it, beside each step's logits, the agents whose draw is used:
    ``rtgs(t, logits, tilt, covered)``, ``actions(t, logits, used)``."""
    wc, mc, pc = cfg.waymo, cfg.model, cfg.policy
    env = WaymoEnv(cfg)
    sampler = sampler if sampler is not None else PolicySampler(cfg, generator)
    steps = cfg.sim.steps
    window = wc.train_context_length
    dev = scenario.traj_position.device

    if groups is None:
        groups = default_groups(cfg, scenario, controlled_mask, crop_size=cfg.eval.agent_slots or None)
    G, Am = groups.num_groups, groups.crop_size
    if Am > wc.max_num_agents:
        raise ValueError(f"crop size {Am} exceeds waymo.max_num_agents {wc.max_num_agents}")
    members = groups.members

    length, width = scenario.length, scenario.width
    E, A = scenario.traj_position.shape[:2]
    EG = E * G

    def eg(x: Tensor) -> Tensor:
        """[E, G, Am, ...] -> [EG, Am, ...]"""
        return x.reshape((EG,) + x.shape[2:])

    goals5 = goals_from_scenario(scenario)
    types = torch.nn.functional.one_hot(scenario.agent_type.long(), wc.num_agent_types).float()
    agent_tilt = agent_tilts(cfg, controlled_mask, tilt_logits)

    env_state = env.reset(scenario)

    # ---- fixed per-lane frame from the t=0 origin's pose ----------------
    alive0_slot = gather_members(env_state.alive, members)
    len_slot = gather_members(groups.gt_length, members)
    okey0 = torch.where(groups.assigned & alive0_slot & groups.member_valid, len_slot, -1.0)
    origin_slot = torch.argmax(okey0, dim=2)  # [E, G], fixed for the episode
    pos_slot0 = gather_members(env_state.bodies.position, members)
    yaw_slot0 = gather_members(env_state.bodies.heading, members)
    opos = eg(torch.gather(pos_slot0, 2, origin_slot[..., None, None].expand(E, G, 1, 2)))[:, 0]
    oyaw = eg(torch.gather(yaw_slot0, 2, origin_slot[..., None]))[:, 0]
    frame = _frame(opos, oyaw)

    goals_slot = eg(gather_members(goals5, members))
    types_slot = eg(gather_members(types, members))
    length_slot = eg(gather_members(length, members))
    width_slot = eg(gather_members(width, members))

    # ---- static inputs in the frame ---------------------------------------
    n_goals = torch.cat(
        [
            apply_se2(goals_slot[..., :2], frame[0][:, None, :], frame[1]),
            apply_se2(goals_slot[..., 2:4], torch.zeros_like(frame[0])[:, None, :], frame[1]),
            angle_sub(goals_slot[..., 4], -frame[1][:, None])[..., None],
        ],
        dim=-1,
    )

    def bcast_groups(x: Tensor) -> Tensor:
        return x[:, None].expand((E, G) + x.shape[1:]).reshape((EG,) + x.shape[1:])

    road_points = bcast_groups(scenario.road_points)
    road_types = bcast_groups(scenario.road_types)
    road_valid = bcast_groups(scenario.road_valid)
    rp_xy = apply_se2(road_points[..., :2], frame[0][:, None, None, :], frame[1])
    n_roads = torch.cat([rp_xy, road_points[..., 2:]], dim=-1)
    n_roads = n_roads * (road_points[..., -1:] > 0)
    # keep the max_num_road_polylines closest polylines in the fixed frame,
    # the crop normalize_scene applies (dataset.py:415-426)
    cap = wc.max_num_road_polylines
    if n_roads.shape[1] > cap:
        max_dist = (torch.linalg.vector_norm(n_roads[..., :2], dim=-1) * n_roads[..., -1]).amax(dim=2)
        max_dist = torch.where(road_valid, max_dist, float("inf"))
        keep = torch.argsort(max_dist, dim=1, stable=True)[:, :cap]
        n_roads = torch.gather(n_roads, 1, keep[:, :, None, None].expand((-1, -1) + n_roads.shape[2:]))
        road_types = torch.gather(road_types, 1, keep[:, :, None].expand(-1, -1, road_types.shape[2]))
        road_valid = torch.gather(road_valid, 1, keep)
    n_roads = n_roads * road_valid[:, :, None, None]
    road_types = torch.where(road_valid[:, :, None], road_types, -1.0)

    relevant = groups.member_valid  # sticky membership, shrinks with distance

    # ---- memory (map + initial states), encoded once -----------------------
    pos0, vel0, hd0 = _normalize_states(
        frame, eg(pos_slot0), eg(gather_members(env_state.bodies.velocity, members)), eg(yaw_slot0)
    )
    init_exist = eg(alive0_slot & relevant).float()
    init_states12 = torch.cat(
        [pos0, vel0, hd0[..., None], length_slot[..., None], width_slot[..., None], types_slot],
        dim=-1,
    )
    memory, memory_valid = model.encode_rollout_memory(
        n_roads, road_types, init_states12, n_goals, init_exist, 0
    )
    memory_kv = model.precompute_memory_kv(memory)
    cache = model.new_cache(EG, Am, device=dev)
    one_pass = mc.trajeglish or mc.il or mc.decision_transformer
    fused = not one_pass and cfg.eval.streaming_passes < 3
    if fused:
        mask1, mask2 = stream_step_masks(
            steps, window, Am, mc.num_token_types, mc.state_token_index,
            mc.attend_own_return_action, device=dev,
        )
    # DT's real-time returns (policy_evaluator.py:123-145), decayed each step
    rtg_rt = initial_real_time_rtgs(cfg, controlled_mask)
    a_ids = torch.arange(Am, device=dev).expand(EG, Am)
    probe_ids = tf.discretize_actions(torch.zeros((EG, Am, 2), device=dev), wc).long()  # trajeglish

    def sample_rtgs(x_state: Tensor, t: int, exist_g: Tensor, group_alive: Tensor) -> tuple[Tensor, Tensor]:
        """The t RTG bins of every slot [EG, Am, 3] from the state rows, one
        tilted draw per agent (the lowest-rank group's logits win), and the
        continuous RTGs [E, A, 3] of the output."""
        if not pc.predict_rtgs:
            return torch.zeros((EG, Am, 3), dtype=torch.long, device=dev), torch.zeros((E, A, 3), device=dev)
        rtg_logits = model.rtg_head(x_state).reshape(E, G, Am, wc.rtg_discretization, 3)
        table_logits, covered = scatter_by_rank(rtg_logits, members, exist_g & group_alive[..., None], A)
        rtg_bins_ag = sampler.rtgs(t, table_logits, agent_tilt, covered)
        rtg_cont = tf.undiscretize_rtgs(rtg_bins_ag, wc) * covered[..., None]
        return eg(gather_members(rtg_bins_ag, members)) * eg(exist_g)[..., None].long(), rtg_cont

    prev_action_ids = torch.zeros((EG, Am), dtype=torch.long, device=dev)
    prev_exist = torch.zeros((EG, Am), device=dev)
    slot_rows = origin_slot[..., None, None].expand(E, G, 1, 2)
    rows = []
    for t in range(steps):
        reward8, env_state = env.reward(scenario, env_state)
        bodies = env_state.bodies

        # relevance shrinks with distance to the origin's current position;
        # slots are masked, never re-sorted
        pos_slot = gather_members(bodies.position, members)
        cur_opos = torch.gather(pos_slot, 2, slot_rows)
        relevant = relevant & (torch.linalg.vector_norm(pos_slot - cur_opos, dim=-1) < wc.agent_dist_threshold)
        alive_slot = gather_members(env_state.alive, members)
        group_alive = (groups.assigned & alive_slot & relevant).any(dim=2) & groups.group_valid
        model_exist_g = alive_slot & relevant
        model_exist = eg(model_exist_g).float()

        p, v, hd = _normalize_states(
            frame, eg(pos_slot), eg(gather_members(bodies.velocity, members)),
            eg(gather_members(bodies.heading, members)),
        )
        states12 = torch.cat(
            [p, v, hd[..., None], length_slot[..., None], width_slot[..., None], types_slot], dim=-1
        )

        if fused:
            # pass 1: (t-1 actions + t states); its state rows feed the RTG head
            x_state, cache = model.stream_action_state(
                prev_action_ids, prev_exist, states12, n_goals, model_exist, t, cache,
                memory_valid, memory_kv, mask_override=mask1[t],
            )
            rtg_bins, rtg_cont = sample_rtgs(x_state, t, model_exist_g, group_alive)
            # pass 2: the t RTG tokens; their rows feed the action head
            x_action, cache = model.stream_rtg(
                rtg_bins, model_exist, t, cache, memory_valid, memory_kv, mask_override=mask2[t]
            )
        elif not one_pass:  # the sequential 3-pass decode
            _, cache = model.stream_prev_action(prev_action_ids, prev_exist, t, cache, memory_valid, memory_kv)
            x_state, cache = model.stream_state(states12, n_goals, model_exist, t, cache, memory_valid, memory_kv)
            rtg_bins, rtg_cont = sample_rtgs(x_state, t, model_exist_g, group_alive)
            x_action, cache = model.stream_rtg(rtg_bins, model_exist, t, cache, memory_valid, memory_kv)
        else:
            # one pass: the t-1 action group, then this step's groups; every
            # group is written before any attends (DT's rtg token sees the
            # same step's state token, which comes later in flat order)
            enc, ex = model.encoder, model_exist[..., None]
            rtg_cont = torch.zeros((E, A, 3), device=dev)
            t_ids = torch.full((EG, Am), t, dtype=torch.long, device=dev)
            t_prev_ids = torch.full((EG, Am), max(t - 1, 0), dtype=torch.long, device=dev)
            if mc.trajeglish:
                new = [(enc.embed_action_tokens(probe_ids, t_ids, a_ids, ex), 0)]
            elif mc.il:
                new = [(enc.embed_state_tokens(states12, n_goals, t_ids, a_ids, ex), mc.state_token_index)]
            else:
                n_rtg3 = tf.normalize_rtgs(eg(gather_members(rtg_rt, members)), wc) * ex
                new = [(enc.embed_rtg_tokens(n_rtg3, t_ids, a_ids, ex), 0),
                       (enc.embed_state_tokens(states12, n_goals, t_ids, a_ids, ex), mc.state_token_index)]
                # the next step's rtg token carries the decayed value (policy_evaluator.py:146-149)
                rtg_rt = rtg_rt - dt_dense_reward3(cfg, scenario, env_state, reward8)
            e_prev = enc.embed_action_tokens(prev_action_ids, t_prev_ids, a_ids, prev_exist[..., None])
            emb = enc.embed_ln(torch.cat([e_prev] + [e for e, _ in new], dim=1))
            groups_t = [(emb[:, :Am], mc.num_token_types - 1, t - 1)] + [
                (emb[:, (i + 1) * Am:(i + 2) * Am], k, t) for i, (_, k) in enumerate(new)]
            x, cache = model.decoder.decode_step_groups(groups_t, cache, memory_valid, window, memory_kv)
            x_action = x[:, -Am:]  # the last group's rows: the state (DT, IL) or the probe (trajeglish)
        logits = model.action_head(x_action).reshape(E, G, Am, -1)
        contrib = model_exist_g & group_alive[..., None] & groups.group_valid[..., None]
        table_action_logits, act_covered = scatter_by_rank(logits, members, contrib, A)
        # the agents whose sampled action is applied (applied_actions' use_policy)
        used = act_covered & controlled_mask & env_state.alive & (t >= cfg.sim.history_steps - 1)
        action_ids = sampler.actions(t, table_action_logits, used)
        policy_actions = tf.undiscretize_actions(action_ids, wc) * act_covered[..., None]

        # ---- applied actions: policy after the history, GT replay otherwise
        accel, steer, alive_next = applied_actions(cfg, scenario, env_state, t, controlled_mask, policy_actions)
        # the applied ids enter each lane's cache at the start of the next step
        applied_ids = tf.discretize_actions(torch.stack([accel, steer], dim=-1), wc).long()
        rows.append(step_record(env_state, reward8, accel, steer, rtg_cont))
        env_state = env.step(
            scenario, env_state, accel, steer,
            expert_mask=torch.zeros_like(alive_next), alive_next=alive_next,
        )
        prev_action_ids = eg(gather_members(applied_ids, members))
        prev_exist = model_exist

    return finish_rollout(env, scenario, env_state, rows, controlled_mask)
