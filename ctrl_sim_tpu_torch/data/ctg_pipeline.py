"""CTG++ samples: offline replay arrays -> diffusion batches, and the frame
transforms the CTG++ rollout shares (port of
``ctrl_sim_tpu/data/ctg_pipeline.py``; reference
datasets/rl_waymo/dataset_ctg_plus_plus.py).

Past (10) / future (22) split, per-agent local frames, 7-d pairwise
relative encodings, per-agent road crops, continuous actions normalized to
[-1, 1], diffusion state normalization (positions / ``pos_div``, velocities
/ ``vel_div``) and RTGs discretized on the past slice only. The JAX package
vmaps per-scene functions; here each works on a batch of scenes [E, ...].
The three random draws of a sample come from a ``torch.Generator``, or are
given (``pipeline.TrainDraws``) so that a test can replay the JAX draws.
"""

from __future__ import annotations

import math

import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data import transforms as tf
from ctrl_sim_tpu_torch.data.datagen import OfflineArrays
from ctrl_sim_tpu_torch.data.pipeline import TrainDraws, compute_rtgs, goals_from_scenario
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.geometry import angle_sub, apply_se2

Tensor = torch.Tensor


def _frames(anchor: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Each agent's frame at its anchor state [E, A, 8]: rotation pi/2 +
    sign(-yaw) |yaw| [E, A], translation [E, A, 2], anchor existence [E, A]."""
    yaw = anchor[..., 4]
    return (math.pi / 2) + torch.sign(-yaw) * yaw.abs(), anchor[..., :2], anchor[..., -1] > 0


def agents_local_frame(states: Tensor, anchor: Tensor) -> Tensor:
    """Per-agent local frames (_get_agents_local_frame, :184-232): states
    [E, A, T, 8] (x, y, vx, vy, yaw, L, W, exist), anchor [E, A, 8] ->
    [E, A, T, 13] = [local (x, y, vx, vy, yaw), global (x, y, vx, vy, yaw),
    L, W, exist]. Agents missing at the anchor keep zero local coordinates."""
    rot, trans, valid = _frames(anchor)
    local_pos = apply_se2(states[..., :2], trans[..., None, :], rot)
    local_vel = apply_se2(states[..., 2:4], torch.zeros_like(trans)[..., None, :], rot)
    local_yaw = angle_sub(states[..., 4], -rot[..., None])
    local5 = torch.cat([local_pos, local_vel, local_yaw[..., None]], dim=-1) * valid[..., None, None]
    return torch.cat([local5, states[..., :5], states[..., 5:]], dim=-1)


def roads_local_frame(roads: Tensor, anchor: Tensor) -> Tensor:
    """Per-agent road crops [E, A, P, L, 3] into each agent's frame; invalid
    points zeroed (:170)."""
    rot, trans, valid = _frames(anchor)
    xy = apply_se2(roads[..., :2], trans[:, :, None, None, :], rot)
    xy = torch.where(valid[..., None, None, None], xy, roads[..., :2])
    return torch.cat([xy, roads[..., 2:]], dim=-1) * (roads[..., -1:] > 0)


def goals_local_frame(goals: Tensor, anchor: Tensor) -> Tensor:
    """Goals [E, A, 5] (x, y, vx, vy, heading) into each agent's frame."""
    rot, trans, valid = _frames(anchor)
    gp = apply_se2(goals[..., :2], trans, rot)
    gv = apply_se2(goals[..., 2:4], torch.zeros_like(trans), rot)
    gh = angle_sub(goals[..., 4], -rot)
    out = torch.cat([gp, gv, gh[..., None]], dim=-1)
    return torch.where(valid[..., None], out, goals)


def relative_encodings(in_states13: Tensor, present13: Tensor) -> Tensor:
    """7-d pairwise relative encodings (_prepare_relative_encodings,
    :76-118): in_states13 [E, A, T, 13], present13 [E, A, 13] ->
    [E, A, A, T, 7], where rel[i, j, t] encodes agent j at step t in agent
    i's present frame:

      [0:2] R_i (pos_j_t - pos_i_present)
      [2]   cos(yaw_j_t - yaw_i_present)
      [3]   sin(yaw_j_t - yaw_i_present)
      [4]   |v_j_t| * rel[3] - |v_i_present|
      [5]   |v_j_t| * rel[4]        (the reference's behaviour)
      [6]   || pos_i_t - pos_j_t ||
    """
    present_heading = present13[..., 9]
    c = torch.cos(-present_heading + math.pi / 2)[:, :, None, None]
    s = torch.sin(-present_heading + math.pi / 2)[:, :, None, None]
    gpos, ppos = in_states13[..., 5:7], present13[..., 5:7]
    gyaw, pyaw = in_states13[..., 9], present13[..., 9]
    gspeed = torch.linalg.norm(in_states13[..., 2:4], dim=-1)  # [E, A, T] (local velocity)
    pspeed = torch.linalg.norm(present13[..., 2:4], dim=-1)  # [E, A]

    offsets = gpos[:, None] - ppos[:, :, None, None, :]  # [E, i, j, T, 2]
    rx = offsets[..., 0] * c - offsets[..., 1] * s
    ry = offsets[..., 0] * s + offsets[..., 1] * c
    yaw_off = gyaw[:, None] - pyaw[:, :, None, None]
    r2, r3 = torch.cos(yaw_off), torch.sin(yaw_off)
    r4 = gspeed[:, None] * r3 - pspeed[:, :, None, None]
    r5 = gspeed[:, None] * r4
    r6 = torch.linalg.norm(gpos[:, :, None] - gpos[:, None, :], dim=-1)  # [E, i, j, T]
    return torch.stack([rx, ry, r2, r3, r4, r5, r6], dim=-1)


def select_agent_roads(
    anchor_pos: Tensor,  # [E, A, 2] present positions
    anchor_exist: Tensor,  # [E, A] float
    road_points: Tensor,  # [E, P, L, 3]
    road_types: Tensor,  # [E, P, 8]
    road_valid: Tensor,  # [E, P] bool
    max_polylines: int,
) -> tuple[Tensor, Tensor]:
    """Per-agent top-K road crops (select_indiv_agent_roads, :120-141): the
    K polylines whose farthest valid point is nearest the agent, [E, A, K,
    L, 3] and [E, A, K, 8]. When P <= K nothing is sorted: the polylines
    keep their order, padded with zero points and -1 types. The sort is
    stable, as ``jnp.argsort`` is. Rows of agents missing at the anchor are
    zeroed."""
    E, A = anchor_exist.shape
    P = road_points.shape[1]
    valid = road_valid.to(road_points.dtype)
    if P <= max_polylines:
        pad = max_polylines - P
        rp = (road_points * valid[:, :, None, None])[:, None].expand((E, A) + tuple(road_points.shape[1:]))
        rt = torch.where(road_valid[:, :, None], road_types, -1.0)[:, None].expand((E, A) + tuple(road_types.shape[1:]))
        if pad:
            rp = torch.cat([rp, rp.new_zeros((E, A, pad) + tuple(road_points.shape[2:]))], dim=2)
            rt = torch.cat([rt, rt.new_full((E, A, pad, road_types.shape[-1]), -1.0)], dim=2)
    else:
        dist = torch.linalg.norm(road_points[:, None, :, :, :2] - anchor_pos[:, :, None, None, :], dim=-1)
        dist = torch.where(road_points[:, None, :, :, -1] > 0, dist, -math.inf)
        max_dist = dist.amax(dim=-1)  # [E, A, P]
        max_dist = torch.where(road_valid[:, None, :], max_dist, math.inf)
        max_dist = torch.where(torch.isneginf(max_dist), math.inf, max_dist)
        keep = torch.argsort(max_dist, dim=-1, stable=True)[..., :max_polylines]  # [E, A, K]
        flat = keep.reshape(E, -1)
        rp = torch.gather(road_points, 1, flat[:, :, None, None].expand((-1, -1) + tuple(road_points.shape[2:])))
        rt = torch.gather(road_types, 1, flat[:, :, None].expand(-1, -1, road_types.shape[-1]))
        kept_valid = torch.gather(road_valid, 1, flat).reshape(E, A, max_polylines)
        rp = rp.reshape((E, A, max_polylines) + tuple(road_points.shape[2:])) * kept_valid[..., None, None]
        rt = torch.where(kept_valid[..., None], rt.reshape(E, A, max_polylines, -1), -1.0)
    rp = torch.cat([rp[..., :-1], rp[..., -1:] * anchor_exist[:, :, None, None, None]], dim=-1)
    return rp, rt * anchor_exist[:, :, None, None]


def normalize_actions(a: Tensor, wc) -> Tensor:
    """Continuous (accel, steer) -> [-1, 1] (dataset_ctg_plus_plus.py:234-240)."""
    accel = (a[..., 0].clamp(wc.min_accel, wc.max_accel) - wc.min_accel) / (wc.max_accel - wc.min_accel)
    steer = (a[..., 1].clamp(wc.min_steer, wc.max_steer) - wc.min_steer) / (wc.max_steer - wc.min_steer)
    return 2.0 * torch.stack([accel, steer], dim=-1) - 1.0


def unnormalize_actions(a: Tensor, wc) -> Tensor:
    """[-1, 1] -> (accel, steer) (dataset_ctg_plus_plus.py:242-247)."""
    a = (a + 1.0) / 2.0
    accel = a[..., 0] * (wc.max_accel - wc.min_accel) + wc.min_accel
    steer = a[..., 1] * (wc.max_steer - wc.min_steer) + wc.min_steer
    return torch.stack([accel, steer], dim=-1)


def scale_states(x: Tensor, wc) -> Tensor:
    """Diffusion normalization (:403-408): positions / pos_div, velocities
    / vel_div."""
    return torch.cat([x[..., :2] / wc.pos_div, x[..., 2:4] / wc.vel_div, x[..., 4:]], dim=-1)


def past_conditioning(cfg: Config, past: Tensor, goals: Tensor, road_points: Tensor, road_types: Tensor,
                      road_valid: Tensor) -> dict:
    """The per-agent-frame pieces of the conditioning that the past slice
    [E, A, T_in, 8] gives, with each agent's anchor its present state:
    local past states, relative encodings, road crops, goals (normalized
    for the diffusion), the present-step global block and the anchor."""
    wc = cfg.waymo
    anchor = past[:, :, -1]
    rp, rt = select_agent_roads(anchor[..., :2], (anchor[..., -1] > 0).float(), road_points, road_types, road_valid,
                                wc.max_num_road_polylines)
    past13 = agents_local_frame(past, anchor)
    present13 = past13[:, :, -1]
    past_rel = relative_encodings(past13, present13)
    rp = roads_local_frame(rp, anchor)
    return {
        "agent_past_states": scale_states(torch.cat([past13[..., 0:5], past13[..., 10:]], dim=-1), wc),
        "past_relative_encodings": past_rel,
        "goals": scale_states(goals_local_frame(goals, anchor), wc),
        "road_points": torch.cat([rp[..., :2] / wc.pos_div, rp[..., 2:]], dim=-1),
        "road_types": rt,
        "present13": present13,
        "anchor": anchor,
    }


def repeated_present_encodings(past_rel: Tensor, T_out: int) -> Tensor:
    """The future relative encodings without ``future_relative_encoding``:
    the present step's, repeated over the future."""
    return past_rel[:, :, :, -1:].expand(past_rel.shape[:3] + (T_out, 7))


def build_ctg_sample(
    cfg: Config,
    states: Tensor,  # [E, A, T, 8]
    actions: Tensor,  # [E, A, T, 2]
    rtgs: Tensor,  # [E, A, T, 3] normalized
    goals: Tensor,  # [E, A, 5]
    agent_valid: Tensor,  # [E, A] bool
    road_points: Tensor,  # [E, P, L, 3]
    road_types: Tensor,  # [E, P, 8]
    road_valid: Tensor,  # [E, P] bool
    generator: torch.Generator | None = None,
    draws: TrainDraws | None = None,
    train: bool = True,
) -> dict:
    """One CTG++ sample per scene: a window of ``train_context_length``
    steps starting uniformly before the last existence of a moving agent
    (less the past), an origin agent uniform over the moving agents that
    exist at the present step, the relevant agents around it (shuffled in
    training), split at ``input_horizon`` into past and future."""
    wc = cfg.waymo
    T_ctx, T_in, K = wc.train_context_length, wc.input_horizon, wc.max_num_agents
    E, A, T, _ = states.shape
    dev = states.device
    existence = states[..., -1]

    dist0 = torch.linalg.norm(states[:, :, 0, :2] - goals[..., :2], dim=-1)
    moving = (dist0 > wc.moving_threshold) & agent_valid
    filtered = (existence[:, :, 0] > 0) & agent_valid
    exists = existence > 0
    last_exist = torch.where(exists.any(dim=-1), (T - 1) - torch.flip(exists, [-1]).int().argmax(dim=-1), -1)
    max_t = (torch.where(moving, last_exist, -1).amax(dim=-1) - (T_in + 1)).clamp(min=0)

    u = None
    if draws is None:  # uniforms for the window start, the origin agent and the shuffle
        gdev = generator.device if generator is not None else dev
        u = torch.rand((E, 1 + A + K), generator=generator, device=gdev).to(dev)
    origin_t = (draws.origin_t.to(dev).long() if draws is not None
                else torch.minimum((u[:, 0] * (max_t + 1).float()).long(), max_t))

    def window(x: Tensor, t_idx: Tensor) -> Tensor:  # [E, A, T, C] -> [E, A, T_ctx, C]
        return torch.gather(x, 2, t_idx[:, None, :, None].expand(E, A, T_ctx, x.shape[-1]))

    t_idx = origin_t[:, None] + torch.arange(T_ctx, device=dev)
    t_safe = t_idx.clamp(max=T - 1)
    in_episode = (t_idx < T)[:, None, :, None]
    w_states = window(states, t_safe) * in_episode
    # a[t] is the action into state t (dataset_ctg_plus_plus.py:337-342):
    # shifted right by one, zero at the start
    w_actions = window(actions, (t_idx - 1).clamp(min=0, max=T - 1))
    w_actions = w_actions * ((t_idx > 0) & (t_idx - 1 < T))[:, None, :, None]
    w_rtgs = window(rtgs, t_safe) * in_episode

    if draws is not None:
        origin_agent, perm = draws.origin_agent.to(dev).long(), draws.perm.to(dev).long()
    else:
        # uniform over the moving agents present at the window's present step
        cand = (w_states[:, :, T_in, -1] > 0) & moving & filtered
        origin_agent = torch.where(cand, u[:, 1:1 + A], -1.0).argmax(dim=-1)
        perm = torch.argsort(u[:, 1 + A:], dim=-1)
    sel = tf.select_relevant_agents_idx(w_states[:, :, 0, :2], filtered, origin_agent, wc,
                                        perm=perm if train else None)
    s_states = tf.gather_agents(w_states, sel)
    past, future = s_states[:, :, :T_in], s_states[:, :, T_in:]
    anchor = past[:, :, -1]

    ctx = past_conditioning(cfg, past, tf.gather_agents(goals, sel), road_points, road_types, road_valid)
    future13 = agents_local_frame(future, anchor)
    if wc.future_relative_encoding:
        future_rel = relative_encodings(future13, ctx["present13"])
    else:
        future_rel = repeated_present_encodings(ctx["past_relative_encodings"], T_ctx - T_in)
    n_actions = normalize_actions(tf.gather_agents(w_actions, sel), wc)
    present_t = origin_t + T_in - 1
    return {
        "agent_past_states": ctx["agent_past_states"],  # [E, K, T_in, 8]
        "agent_past_actions": n_actions[:, :, :T_in],
        "agent_future_states": scale_states(torch.cat([future13[..., 0:5], future13[..., -1:]], dim=-1), wc),
        "agent_future_actions": n_actions[:, :, T_in:],
        "past_relative_encodings": ctx["past_relative_encodings"],
        "future_relative_encodings": future_rel,
        "goals": ctx["goals"],
        "rtgs": tf.discretize_rtgs(tf.gather_agents(w_rtgs, sel), wc)[:, :, :T_in],
        "timesteps": present_t[:, None].expand(E, T_ctx).int(),
        "moving_agent_mask": tf.gather_agents(moving.float(), sel),
        "road_points": ctx["road_points"],  # [E, K, P, L, 3]
        "road_types": ctx["road_types"],
        "gather_idx": sel.gather_idx,
        "slot_valid": sel.slot_valid,
        "origin_idx": sel.new_origin_idx,
        "anchor": anchor,
    }


def build_ctg_batch(
    cfg: Config,
    scenario: Scenario,
    offline: OfflineArrays,
    generator: torch.Generator | None = None,
    draws: TrainDraws | None = None,
    train: bool = True,
) -> dict:
    """A CTG++ batch of one sample per scene of ``scenario`` (tensor fields,
    one device with ``offline``), with the agent-type one-hots gathered
    into the selected slots (-1 rows where a slot is empty)."""
    batch = build_ctg_sample(
        cfg, offline.states, offline.actions, compute_rtgs(cfg, offline), goals_from_scenario(scenario),
        scenario.agent_valid, scenario.road_points, scenario.road_types, scenario.road_valid,
        generator=generator, draws=draws, train=train,
    )
    n = cfg.waymo.num_agent_types
    onehot = (scenario.agent_type[..., None] == torch.arange(n, device=scenario.agent_type.device)).float()
    gathered = torch.gather(onehot, 1, batch["gather_idx"][..., None].expand(-1, -1, n))
    batch["agent_types"] = torch.where(batch["slot_valid"][..., None], gathered, -1.0)
    return batch
