"""Planner-vs-adversary evaluation (port of
``ctrl_sim_tpu/evals/planner_adversary.py``; reference
evaluators/planner_adversary_evaluator.py + eval_planner.py).

Per scene: an ego vehicle driven by a positively tilted planner policy and an
adversary driven by a negatively tilted policy — or by a replayed CAT
trajectory through physics — with every other agent log-replaying. Both run
through one rollout (either ``eval.rollout_mode``) with per-agent tilt
logits; a replayed adversary is realized by swapping its GT trajectory rows
for the CAT trajectory before the rollout (it then is an uncontrolled
log-replay agent whose "log" is the attack), as apply_adv_traj does
(:165-198).

Table-2 metric suite (:200-429): ego goal / progress / CR / CR-with-adv
(with distance-validated collision attribution) / OR / ADE / FDE / accel /
jerk / steer-rate; adversary JSDs + collision speed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ctrl_sim_tpu_torch.config import Config, TiltConfig
from ctrl_sim_tpu_torch.data.scenario import Scenario, stack_scenarios, to_torch
from ctrl_sim_tpu_torch.data.transforms import get_tilt_logits
from ctrl_sim_tpu_torch.evals.cat import polyline_vel, polyline_yaw
from ctrl_sim_tpu_torch.evals.evaluator import (
    _interesting_candidates,
    _moving_vehicle_ids,
    model_device,
    rollout_fn,
)
from ctrl_sim_tpu_torch.device import host
from ctrl_sim_tpu_torch.evals.metrics import gt_nearest_dist_stream, jsd_suite
from ctrl_sim_tpu_torch.rollout.rollout import RolloutOutput


def select_planner_adversary_pair(cfg: Config, scene: Scenario) -> tuple[int, int] | None:
    """Default ego/adversary selection when no CAT eval dict is given: the
    first 'interesting pair' (goal proximity + duration), ego first. The
    reference reads the pair from eval_planner_dict.pkl (initial-position
    matching, :432-463); with such a dict, pass explicit indices."""
    pairs = _interesting_candidates(cfg, scene, _moving_vehicle_ids(scene))
    if not pairs:
        return None
    return pairs[0]


def substitute_adversary_trajectory(scene: Scenario, adversary_idx: int, adv_positions: np.ndarray) -> Scenario:
    """Replace the adversary's GT rows with a CAT trajectory: positions given,
    headings from polyline yaw, speeds from finite differences
    (planner_adversary_evaluator.py:555-563 via get_polyline_yaw/vel)."""
    T1 = scene.traj_position.shape[1]
    adv_positions = np.asarray(adv_positions)[:T1]
    yaw = polyline_yaw(adv_positions)
    speed = np.linalg.norm(polyline_vel(adv_positions), axis=-1)
    tp = scene.traj_position.copy()
    th = scene.traj_heading.copy()
    tsd = scene.traj_speed.copy()
    n = len(adv_positions)
    tp[adversary_idx, :n] = adv_positions
    th[adversary_idx, :n] = yaw
    tsd[adversary_idx, :n] = speed
    return dataclasses.replace(scene, traj_position=tp, traj_heading=th, traj_speed=tsd)


class PlannerAdversaryEvaluator:
    """Planner-vs-adversary evaluation on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""

    def __init__(
        self,
        cfg: Config,
        model,
        planner_tilt: TiltConfig | None = None,
        adversary_tilt: TiltConfig | None = None,
        lane_batch: int = 32,
        device: torch.device | str | None = None,
    ):
        self.cfg = cfg
        self.model = model
        self.lane_batch = lane_batch
        self.device = model_device(model, device)
        # defaults from cfgs/policy/ctrl_sim_planner.yaml / _adversary.yaml
        pt = planner_tilt or TiltConfig(goal_tilt=10.0, veh_veh_tilt=10.0, veh_edge_tilt=10.0)
        at = adversary_tilt or TiltConfig(goal_tilt=0.0, veh_veh_tilt=-10.0, veh_edge_tilt=0.0)
        self.planner_tilt = get_tilt_logits(pt.goal_tilt, pt.veh_veh_tilt, pt.veh_edge_tilt, cfg.waymo, "cpu")
        self.adversary_tilt = get_tilt_logits(at.goal_tilt, at.veh_veh_tilt, at.veh_edge_tilt, cfg.waymo, "cpu")
        # the streaming guard of PolicyEvaluator: a streaming planner eval of
        # a window-anchored model would be silently wrong
        self._rollout = rollout_fn(cfg)

    def evaluate(
        self,
        scenes: list[Scenario],
        pairs: list[tuple[int, int] | None] | None = None,
        adv_trajectories: list[np.ndarray | None] | None = None,
        samplers: list | None = None,
    ) -> dict:
        """pairs[i] = (ego_idx, adversary_idx) or None to auto-select;
        adv_trajectories[i] = CAT positions [T, 2] to replay, else the
        adversary runs the tilted policy. ``samplers[i]``, where given,
        replaces the policy's draws in chunk i."""
        cfg = self.cfg
        selected = []
        for i, scene in enumerate(scenes):
            pair = pairs[i] if pairs is not None else None
            if pair is None:
                pair = select_planner_adversary_pair(cfg, scene)
            if pair is None:
                continue
            adv_traj = adv_trajectories[i] if adv_trajectories else None
            if adv_traj is not None:
                scene = substitute_adversary_trajectory(scene, pair[1], adv_traj)
            selected.append((scene, pair, adv_traj is not None))
        if not selected:
            return {}

        acc: dict[str, list] = {k: [] for k in [
            "goal", "progress", "cr", "cr_w_adv", "offroad", "ade", "fde",
            "accel", "jerk", "steer_rate", "adv_coll_speed",
            "lin_sim", "lin_gt", "ang_sim", "ang_gt", "acc_sim", "acc_gt",
            "nd_sim", "nd_gt",
        ]}
        generator = torch.Generator(device=self.device).manual_seed(cfg.eval.seed)
        for c, i in enumerate(range(0, len(selected), self.lane_batch)):
            chunk = selected[i:i + self.lane_batch]
            batch = stack_scenarios([s for s, _, _ in chunk], cfg)
            E, A = batch.traj_position.shape[:2]
            controlled = torch.zeros((E, A), dtype=torch.bool)
            tilt = torch.zeros((E, A) + tuple(self.planner_tilt.shape))
            egos = np.zeros(E, np.int64)
            advs = np.zeros(E, np.int64)
            for e, (_, (ego, adv), replay_adv) in enumerate(chunk):
                controlled[e, ego] = True
                tilt[e, ego] = self.planner_tilt
                egos[e], advs[e] = ego, adv
                if not replay_adv:
                    controlled[e, adv] = True
                    tilt[e, adv] = self.adversary_tilt
            sc = to_torch(dataclasses.replace(batch, name=""), self.device)
            ro = self._rollout(cfg, self.model, sc, controlled.to(self.device), generator, tilt.to(self.device),
                               sampler=samplers[c] if samplers else None)
            self._accumulate(acc, RolloutOutput(*(host(x) for x in ro)), batch, egos, advs)
        return self._finalize(acc)

    # ------------------------------------------------------------------
    def _accumulate(
        self, acc: dict, ro: RolloutOutput, batch: Scenario,
        egos: np.ndarray, advs: np.ndarray,
    ) -> None:
        cfg = self.cfg
        steps, hist, dt = cfg.sim.steps, cfg.sim.history_steps, cfg.sim.dt
        exist = ro.existence.transpose(1, 2, 0)
        pos = ro.position.transpose(1, 2, 0, 3)
        vel = ro.velocity.transpose(1, 2, 0, 3)
        heading = ro.heading.transpose(1, 2, 0)
        reward8 = ro.reward8.transpose(1, 2, 0, 3)
        accel = ro.acceleration.transpose(1, 2, 0)
        steer = ro.steering.transpose(1, 2, 0)
        nearest = ro.nearest_dist.transpose(1, 2, 0)
        gt_pos = batch.traj_position[:, :, : steps + 1]
        gt_heading = batch.traj_heading[:, :, : steps + 1]
        gt_speed = batch.traj_speed[:, :, : steps + 1]
        gt_accel = np.zeros_like(gt_speed)
        gt_accel[:, :, 1:steps] = (gt_speed[:, :, 2:] - gt_speed[:, :, :-2]) / (2 * dt)
        # true GT nearest-distance stream: GT positions, sim existence
        # (evaluator.py:94-101 compute_nearest_dist_all gt_ag_data)
        gt_nearest = gt_nearest_dist_stream(gt_pos, exist)

        future = np.zeros(steps + 1, dtype=bool)
        future[hist:] = True
        E = exist.shape[0]
        for e in range(E):
            ego, adv = int(egos[e]), int(advs[e])
            mask = (exist[e, ego] > 0) & future
            if mask.sum() == 0:
                continue
            rew = reward8[e, ego][mask]
            goal_achieved = bool(np.any(rew[:, 0] == 1))
            acc["goal"].append(float(goal_achieved))
            acc["cr"].append(float(np.any(rew[:, 6] == 1)))
            acc["offroad"].append(float(np.any(rew[:, 7] == 1)))

            sp, gp = pos[e, ego], gt_pos[e, ego]
            acc["ade"].append(float(np.linalg.norm(sp[mask] - gp[mask], axis=1).mean()))
            last = np.where(mask)[0][-1]
            acc["fde"].append(float(np.linalg.norm(sp[last] - gp[last])))

            # ego progress (:247-255)
            if goal_achieved:
                prog = np.linalg.norm(
                    np.diff(sp[hist : last + 1], axis=0), axis=-1
                ).sum()
            else:
                d2g = np.linalg.norm(sp[hist : last + 1] - gp[last][None], axis=-1)
                closer = np.diff(d2g) < 0
                per = np.linalg.norm(np.diff(sp[hist : last + 1], axis=0), axis=-1)
                prog = per[closer].sum()
            acc["progress"].append(float(prog))

            ego_acc = np.concatenate([accel[e, ego], [0.0]])[mask]
            acc["accel"].append(np.abs(ego_acc))
            acc["jerk"].append(np.abs(np.diff(ego_acc)) / dt)
            ego_st = np.concatenate([steer[e, ego], [0.0]])[mask]
            acc["steer_rate"].append(np.abs(np.diff(ego_st)) / dt)

            # adversary realism streams
            amask = (exist[e, adv] > 0) & future
            if amask.sum() != 0:
                acc["lin_sim"].append(np.linalg.norm(vel[e, adv][amask], axis=1))
                acc["lin_gt"].append(gt_speed[e, adv][amask])
                acc["ang_sim"].append(heading[e, adv][amask] / dt)
                acc["ang_gt"].append(gt_heading[e, adv][amask] / dt)
                am = np.ones(amask.sum(), bool)
                am[0] = am[-1] = False
                acc["acc_sim"].append(np.concatenate([accel[e, adv], [0.0]])[amask][am])
                acc["acc_gt"].append(gt_accel[e, adv][amask][am])
                acc["nd_sim"].append(nearest[e, adv][amask])
                acc["nd_gt"].append(gt_nearest[e, adv][amask])

            # collision with adversary, distance-validated (:322-358)
            cr_w_adv = 0.0
            if amask.sum() != 0:
                er = reward8[e, ego][mask][:, 6]
                ar = reward8[e, adv][amask][:, 6]
                n = min(len(er), len(ar))
                both = ((er[:n] == ar[:n]) & (er[:n] > 0))
                if np.any(both):
                    ep = pos[e, ego][mask][:n]
                    ap = pos[e, adv][amask][:n]
                    thresh = float(batch.length[e, ego] + batch.length[e, adv])
                    for ci in np.where(both)[0]:
                        if np.linalg.norm(ep[ci] - ap[ci]) < thresh:
                            cr_w_adv = 1.0
                            speed_at = float(
                                np.linalg.norm(vel[e, adv][amask][ci])
                            )
                            acc["adv_coll_speed"].append(speed_at)
                            break
            acc["cr_w_adv"].append(cr_w_adv)

    # ------------------------------------------------------------------
    def _finalize(self, acc: dict) -> dict:
        def mean(xs):
            return float(np.mean(xs)) if len(xs) else 0.0

        def catm(xs):
            return float(np.concatenate(xs).mean()) if xs else 0.0

        m = {
            "ego_goal": mean(acc["goal"]),
            "ego_prog": mean(acc["progress"]),
            "ego_cr": mean(acc["cr"]),
            "ego_cr_w_adv": mean(acc["cr_w_adv"]),
            "ego_or": mean(acc["offroad"]),
            "ego_ade": mean(acc["ade"]),
            "ego_fde": mean(acc["fde"]),
            "ego_accel": catm(acc["accel"]),
            "ego_jerk": catm(acc["jerk"]),
            "ego_steer_rate": catm(acc["steer_rate"]),
            "adv_coll_speed": mean(acc["adv_coll_speed"]),
        }
        # pooled-stream JSDs; reference key names
        # (planner_adversary_evaluator.py:394-427: adv_lin_jsd, adv_ang_jsd,
        # adv_acc_jsd, nearest_dist_jsd)
        js = jsd_suite(
            self.cfg,
            acc["lin_sim"], acc["lin_gt"], acc["ang_sim"], acc["ang_gt"],
            acc["acc_sim"], acc["acc_gt"], acc["nd_sim"], acc["nd_gt"],
        )
        m["adv_lin_jsd"] = js["lin_speed_jsd"]
        m["adv_ang_jsd"] = js["ang_speed_jsd"]
        m["adv_acc_jsd"] = js["accel_jsd"]
        m["nearest_dist_jsd"] = js["nearest_dist_jsd"]
        return m
