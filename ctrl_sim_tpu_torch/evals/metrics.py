"""Closed-loop evaluation metrics: the Table-1 suite (port of
``ctrl_sim_tpu/evals/metrics.py``; reference PolicyEvaluator.
update_running_statistics + compute_metrics, evaluators/policy_evaluator.py:
162-305), over the rollout streams of either rollout mode:

- goal success rate: any post-history step with position-target achieved
- collision / offroad rate: per-scenario mean over evaluated agents
- ADE / FDE vs ground truth over existing steps
- Jensen-Shannon distances of linear speed, angular speed, acceleration
  and nearest-vehicle distance, with the reference's fixed binnings
  (200 bins over [0,30] m/s; 200 over [-50,50] rad/s; 20 accel bins over
  [-10,10] with GT accel round-tripped through the action discretizer;
  200 over [0,40] m).

Per-vehicle streams are pooled over every scene and chunk
(``PolicyMetricsAccumulator.update`` per chunk) and each JSD is computed
once over the pooled streams (``compute``), never averaged across chunks.
Host-side numpy: O(E*A*T) work once per evaluation.
"""

from __future__ import annotations

import numpy as np

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.device import host
from ctrl_sim_tpu_torch.rollout.rollout import RolloutOutput


def _jsd(p: np.ndarray, q: np.ndarray) -> float:
    """Jensen-Shannon *distance* (sqrt of divergence, base e), matching
    scipy.spatial.distance.jensenshannon."""
    p = p / max(p.sum(), 1e-12)
    q = q / max(q.sum(), 1e-12)
    m = 0.5 * (p + q)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log(a[mask] / b[mask])))

    return float(np.sqrt(max(0.5 * kl(p, m) + 0.5 * kl(q, m), 0.0)))


def gt_nearest_dist_stream(
    gt_pos: np.ndarray, exist: np.ndarray
) -> np.ndarray:
    """Nearest-vehicle distance over GT positions with *sim* existence
    masking (evaluator.py:94-97 compute_nearest_dist_all: gt_ag_data uses
    gt positions but all_existence from the simulated state).

    gt_pos: [E, A, T+1, 2]; exist: [E, A, T+1] -> [E, A, T+1].
    """
    E, A, T1 = exist.shape
    out = np.zeros((E, A, T1))
    # (inf - inf -> nan in the pairwise diff of absent agents is expected and
    #  resolved by the min/isfinite handling below)
    old_err = np.seterr(invalid="ignore")
    idx = np.arange(A)
    for t in range(T1):
        p = gt_pos[:, :, t]
        e = exist[:, :, t]
        masked = np.where(e[..., None] > 0, p, np.inf)
        d = masked[:, :, None, :] - masked[:, None, :, :]
        sq = np.sum(d * d, axis=-1)
        # inf-inf pairs (both absent) produce nan; treat as "no neighbor"
        # without clamping legitimate inf (np.nan_to_num would make those
        # finite and defeat the isfinite -> 0 rule below)
        sq = np.where(np.isnan(sq), np.inf, sq)
        sq[:, idx, idx] = np.inf
        nd = np.sqrt(np.min(sq, axis=2))
        nd[~np.isfinite(nd)] = 0.0
        out[:, :, t] = nd * e
    np.seterr(**old_err)
    return out


def jsd_suite(
    cfg: Config,
    lin_sim, lin_gt, ang_sim, ang_gt, acc_sim, acc_gt, nd_sim, nd_gt,
    prefix: str = "",
) -> dict:
    """The four Table-1 JSDs over pooled streams, reference binnings
    (policy_evaluator.py:261-303). Inputs are lists of 1-D arrays."""
    wc = cfg.waymo

    def cat(xs):
        return np.concatenate(xs) if xs else np.zeros(0)

    out = {}
    ls, lg = np.clip(cat(lin_sim), 0, 30), np.clip(cat(lin_gt), 0, 30)
    edges = np.arange(201) * 0.5 * (100 / 30)
    out[prefix + "lin_speed_jsd"] = _jsd(
        np.histogram(ls, bins=edges)[0].astype(float),
        np.histogram(lg, bins=edges)[0].astype(float),
    )
    asim, agt = np.clip(cat(ang_sim), -50, 50), np.clip(cat(ang_gt), -50, 50)
    edges = np.arange(201) * 0.5 - 50
    out[prefix + "ang_speed_jsd"] = _jsd(
        np.histogram(asim, bins=edges)[0].astype(float),
        np.histogram(agt, bins=edges)[0].astype(float),
    )
    # GT accel round-tripped through the action discretizer
    # (policy_evaluator.py:283-288)
    ag = cat(acc_gt)
    ag = (np.clip(ag, wc.min_accel, wc.max_accel) - wc.min_accel) / (
        wc.max_accel - wc.min_accel
    )
    ag = np.round(ag * (wc.accel_discretization - 1)) / (wc.accel_discretization - 1)
    ag = ag * (wc.max_accel - wc.min_accel) + wc.min_accel
    edges = np.arange(wc.accel_discretization + 1) * 2 - wc.accel_discretization
    out[prefix + "accel_jsd"] = _jsd(
        np.histogram(cat(acc_sim), bins=edges)[0].astype(float),
        np.histogram(ag, bins=edges)[0].astype(float),
    )
    ns, ng = np.clip(cat(nd_sim), 0, 40), np.clip(cat(nd_gt), 0, 40)
    edges = np.arange(201) * 0.5 * (100 / 40)
    out[prefix + "nearest_dist_jsd"] = _jsd(
        np.histogram(ns, bins=edges)[0].astype(float),
        np.histogram(ng, bins=edges)[0].astype(float),
    )
    return out


class PolicyMetricsAccumulator:
    """Running statistics over every evaluated vehicle in every scene,
    mirroring the reference's `*_all` lists (policy_evaluator.py:52-76) so
    the final JSDs/means are computed over the pooled population, not
    averaged per chunk."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.goal_achieved_all: list[float] = []
        self.collision_rate_scenario: list[float] = []
        self.offroad_rate_scenario: list[float] = []
        self.ades_all: list[float] = []
        self.fdes_all: list[float] = []
        self.lin_sim: list[np.ndarray] = []
        self.lin_gt: list[np.ndarray] = []
        self.ang_sim: list[np.ndarray] = []
        self.ang_gt: list[np.ndarray] = []
        self.acc_sim: list[np.ndarray] = []
        self.acc_gt: list[np.ndarray] = []
        self.nd_sim: list[np.ndarray] = []
        self.nd_gt: list[np.ndarray] = []

    def update(self, rollout: RolloutOutput, scenario: Scenario) -> None:
        """Accumulate one lane chunk (update_running_statistics per scene)."""
        cfg = self.cfg
        steps = cfg.sim.steps
        hist = cfg.sim.history_steps
        dt = cfg.sim.dt

        # [E, A, T+1, ...] layouts, agent-major
        exist = host(rollout.existence).transpose(1, 2, 0)  # [E, A, T+1]
        pos = host(rollout.position).transpose(1, 2, 0, 3)
        vel = host(rollout.velocity).transpose(1, 2, 0, 3)
        heading = host(rollout.heading).transpose(1, 2, 0)
        reward8 = host(rollout.reward8).transpose(1, 2, 0, 3)
        accel = host(rollout.acceleration).transpose(1, 2, 0)  # [E, A, T]
        nearest = host(rollout.nearest_dist).transpose(1, 2, 0)
        controlled = host(rollout.controlled_mask)  # [E, A]

        gt_pos = host(scenario.traj_position)[:, :, : steps + 1]
        gt_heading = host(scenario.traj_heading)[:, :, : steps + 1]
        gt_speed = host(scenario.traj_speed)[:, :, : steps + 1]

        # GT central-difference acceleration (policy_evaluator.py:106-111)
        gt_accel = np.zeros_like(gt_speed)
        gt_accel[:, :, 1:steps] = (gt_speed[:, :, 2:] - gt_speed[:, :, :-2]) / (2 * dt)

        gt_nearest = gt_nearest_dist_stream(gt_pos, exist)

        E, A = exist.shape[:2]
        future = np.zeros(steps + 1, dtype=bool)
        future[hist:] = True

        for e in range(E):
            coll_e, off_e = [], []
            for a in range(A):
                if not controlled[e, a]:
                    continue
                mask = (exist[e, a] > 0) & future
                if mask.sum() == 0:
                    continue
                rew = reward8[e, a][mask]
                self.goal_achieved_all.append(float(np.any(rew[:, 0] == 1)))
                coll_e.append(float(np.any(rew[:, 6] == 1)))
                off_e.append(float(np.any(rew[:, 7] == 1)))

                sim_p = pos[e, a]
                gt_p = gt_pos[e, a]
                self.ades_all.append(
                    float(np.linalg.norm(sim_p[mask] - gt_p[mask], axis=1).mean())
                )
                last = np.where(mask)[0][-1]
                self.fdes_all.append(float(np.linalg.norm(sim_p[last] - gt_p[last])))

                self.lin_sim.append(np.linalg.norm(vel[e, a][mask], axis=1))
                self.lin_gt.append(gt_speed[e, a][mask])
                # "angular speed" = heading / dt (policy_evaluator.py:219-220)
                self.ang_sim.append(heading[e, a][mask] / dt)
                self.ang_gt.append(gt_heading[e, a][mask] / dt)

                am = np.ones(mask.sum(), dtype=bool)
                am[0] = False
                am[-1] = False
                sim_acc_steps = np.concatenate([accel[e, a], [0.0]])[mask]
                self.acc_sim.append(sim_acc_steps[am])
                self.acc_gt.append(gt_accel[e, a][mask][am])

                self.nd_sim.append(nearest[e, a][mask])
                self.nd_gt.append(gt_nearest[e, a][mask])
            if coll_e:
                self.collision_rate_scenario.append(float(np.mean(coll_e)))
                self.offroad_rate_scenario.append(float(np.mean(off_e)))

    def compute(self) -> dict:
        """Finalize once over everything accumulated (compute_metrics)."""
        metrics = {
            "goal": float(np.mean(self.goal_achieved_all)) if self.goal_achieved_all else 0.0,
            "collision_rate": float(np.mean(self.collision_rate_scenario)) if self.collision_rate_scenario else 0.0,
            "offroad_rate": float(np.mean(self.offroad_rate_scenario)) if self.offroad_rate_scenario else 0.0,
            "ade": float(np.mean(self.ades_all)) if self.ades_all else 0.0,
            "fde": float(np.mean(self.fdes_all)) if self.fdes_all else 0.0,
        }
        metrics.update(
            jsd_suite(
                self.cfg,
                self.lin_sim, self.lin_gt,
                self.ang_sim, self.ang_gt,
                self.acc_sim, self.acc_gt,
                self.nd_sim, self.nd_gt,
            )
        )
        return metrics


def compute_policy_metrics(
    cfg: Config, rollout: RolloutOutput, scenario: Scenario
) -> dict:
    """Single-chunk convenience wrapper (one update + compute)."""
    acc = PolicyMetricsAccumulator(cfg)
    acc.update(rollout, scenario)
    return acc.compute()
