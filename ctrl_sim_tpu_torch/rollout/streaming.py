"""Streaming closed-loop rollout with incremental KV-cached decoding
(port of ``ctrl_sim_tpu/rollout/streaming.py:run_streaming`` for the
default CtRL-Sim family and the fused 2-pass decode).

Per env step, for every (scene, group) lane at once:

  env reward -> normalize the slots' states in the lane's fixed frame ->
  pass 1: the t-1 action tokens + the t state tokens (stream_action_state)
  -> tilted RTG sampling -> pass 2: the t RTG tokens (stream_rtg) -> action
  sampling -> controlled agents act after the history window, the others
  replay GT through inverse-bicycle actions -> FreeCar step, collisions.

The frame is anchored at the origin agent's pose at episode start, the
memory (map + initial states) and its cross-attention K/V are computed once
per episode, and both passes' [Q, N] masks are precomputed for every step
(ops/masks.py:stream_step_masks). A Python loop over steps takes the place
of ``lax.scan``; the KV ring cache is updated in place.

Not ported yet, and refused: the trajeglish, IL and DT families, the
sequential 3-pass decode (``eval.streaming_passes=3``), the int8 KV cache
and the contact solver.
"""

from __future__ import annotations

import math

import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data import transforms as tf
from ctrl_sim_tpu_torch.data.pipeline import goals_from_scenario
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.env.dynamics import inverse_bicycle_action
from ctrl_sim_tpu_torch.env.env import WaymoEnv
from ctrl_sim_tpu_torch.geometry import angle_sub, apply_se2
from ctrl_sim_tpu_torch.ops.masks import stream_step_masks
from ctrl_sim_tpu_torch.rollout.groups import GroupSpec, gather_members, scatter_by_rank
from ctrl_sim_tpu_torch.rollout.policy import sample_actions, sample_tilted_rtgs
from ctrl_sim_tpu_torch.rollout.rollout import RolloutOutput, _nearest_dist, default_groups

Tensor = torch.Tensor


class PolicySampler:
    """Draws the rollout's RTG bins and action ids with the policy config
    from one ``torch.Generator``. ``run_streaming`` calls
    ``rtgs(t, table_logits [E, A, bins, 3], tilt)`` and
    ``actions(t, table_logits [E, A, num_actions])``; a test can pass
    another object with these two methods to replay given draws."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        self.pc = cfg.policy
        self.generator = generator

    def rtgs(self, t: int, logits: Tensor, tilt: Tensor) -> Tensor:
        return sample_tilted_rtgs(self.generator, logits, tilt)

    def actions(self, t: int, logits: Tensor) -> Tensor:
        pc = self.pc
        return sample_actions(
            self.generator, logits, pc.action_temperature, pc.nucleus_sampling,
            pc.nucleus_threshold,
        )


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
    the ``PolicySampler`` drawing from ``generator`` (tests replay given
    draws through it)."""
    wc, mc, pc = cfg.waymo, cfg.model, cfg.policy
    if mc.trajeglish or mc.il or mc.decision_transformer:
        raise NotImplementedError("only the default CtRL-Sim family is ported")
    if cfg.eval.streaming_passes != 2:
        raise NotImplementedError("only the fused 2-pass streaming decode is ported")
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

    tp, th, ts, tv = (
        scenario.traj_position, scenario.traj_heading, scenario.traj_speed, scenario.traj_valid,
    )
    length, width = scenario.length, scenario.width
    E, A = tp.shape[:2]
    EG = E * G

    def eg(x: Tensor) -> Tensor:
        """[E, G, Am, ...] -> [EG, Am, ...]"""
        return x.reshape((EG,) + x.shape[2:])

    goals5 = goals_from_scenario(scenario)
    types = torch.nn.functional.one_hot(scenario.agent_type.long(), wc.num_agent_types).float()
    if tilt_logits is None:
        tilt_logits = torch.zeros((wc.rtg_discretization, 3), device=dev)
    if tilt_logits.dim() == 2:
        agent_tilt = torch.where(controlled_mask[..., None, None], tilt_logits, 0.0)
    else:
        agent_tilt = tilt_logits

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
    mask1, mask2 = stream_step_masks(
        steps, window, Am, mc.num_token_types, mc.state_token_index,
        mc.attend_own_return_action, device=dev,
    )

    prev_action_ids = torch.zeros((EG, Am), dtype=torch.long, device=dev)
    prev_exist = torch.zeros((EG, Am), device=dev)
    slot_rows = origin_slot[..., None, None].expand(E, G, 1, 2)
    ys = []
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

        # pass 1: (t-1 actions + t states); its state rows feed the RTG head
        x_state, cache = model.stream_action_state(
            prev_action_ids, prev_exist, states12, n_goals, model_exist, t, cache,
            memory_valid, memory_kv, mask_override=mask1[t],
        )
        rtg_cont = torch.zeros((E, A, 3), device=dev)
        if pc.predict_rtgs:
            rtg_logits = model.rtg_head(x_state).reshape(E, G, Am, wc.rtg_discretization, 3)
            contrib = model_exist_g & group_alive[..., None]
            table_logits, covered = scatter_by_rank(rtg_logits, members, contrib, A)
            rtg_bins_ag = sampler.rtgs(t, table_logits, agent_tilt)
            rtg_cont = tf.undiscretize_rtgs(rtg_bins_ag, wc) * covered[..., None]
            rtg_bins = eg(gather_members(rtg_bins_ag, members)) * model_exist[..., None].long()
        else:
            rtg_bins = torch.zeros((EG, Am, 3), dtype=torch.long, device=dev)

        # pass 2: the t RTG tokens; their rows feed the action head
        x_action, cache = model.stream_rtg(
            rtg_bins, model_exist, t, cache, memory_valid, memory_kv, mask_override=mask2[t]
        )
        logits = model.action_head(x_action).reshape(E, G, Am, -1)
        contrib = model_exist_g & group_alive[..., None] & groups.group_valid[..., None]
        table_action_logits, act_covered = scatter_by_rank(logits, members, contrib, A)
        action_ids = sampler.actions(t, table_action_logits)
        policy_actions = tf.undiscretize_actions(action_ids, wc) * act_covered[..., None]

        # ---- applied actions: policy after the history, GT replay otherwise
        gt_accel, gt_steer = inverse_bicycle_action(
            tp[:, :, t + 1], th[:, :, t + 1], ts[:, :, t + 1],
            bodies.position, bodies.heading, bodies.speed, length, cfg.sim.dt,
        )
        replay_valid = env_state.alive & tv[:, :, t] & tv[:, :, t + 1]
        gt_accel = torch.where(replay_valid, gt_accel, 0.0)
        gt_steer = torch.where(replay_valid, gt_steer, 0.0)
        use_policy = controlled_mask & env_state.alive & (t >= cfg.sim.history_steps - 1)
        accel = torch.where(use_policy, policy_actions[..., 0], gt_accel)
        steer = torch.where(use_policy, policy_actions[..., 1], gt_steer)

        # the applied ids enter each lane's cache at the start of the next
        # step, fused with its state pass
        applied_ids = tf.discretize_actions(torch.stack([accel, steer], dim=-1), wc).long()
        alive_next = env_state.alive & tv[:, :, t + 1] & (use_policy | replay_valid)
        ys.append((
            bodies.position, bodies.velocity, bodies.heading, bodies.speed,
            env_state.alive.float(), reward8, accel, steer,
            _nearest_dist(bodies.position, env_state.alive.float()), rtg_cont,
        ))
        env_state = env.step(
            scenario, env_state, accel, steer,
            expert_mask=torch.zeros_like(alive_next), alive_next=alive_next,
        )
        prev_action_ids = eg(gather_members(applied_ids, members))
        prev_exist = model_exist

    final_reward8, final = env.reward(scenario, env_state)
    cols = list(zip(*ys))
    last = (
        final.bodies.position, final.bodies.velocity, final.bodies.heading,
        final.bodies.speed, final.alive.float(), final_reward8,
    )
    stacked = [torch.stack(list(c) + [x]) for c, x in zip(cols[:6], last)]
    return RolloutOutput(
        position=stacked[0],
        velocity=stacked[1],
        heading=stacked[2],
        speed=stacked[3],
        existence=stacked[4],
        reward8=stacked[5],
        acceleration=torch.stack(cols[6]),
        steering=torch.stack(cols[7]),
        nearest_dist=torch.stack(
            list(cols[8]) + [_nearest_dist(final.bodies.position, final.alive.float())]
        ),
        rtgs=torch.stack(cols[9]),
        controlled_mask=controlled_mask,
    )
