"""Closed-loop policy evaluator (port of ``ctrl_sim_tpu/evals/evaluator.py``;
reference eval_sim.py / PolicyEvaluator).

The reference's serial per-scene loop (evaluators/policy_evaluator.py:
426-595) becomes: host-side vehicle selection per scene (seeded with
Python's ``random.Random(eval.seed)``, the same draws as the JAX
evaluator), scenes stacked into chunks of ``lane_batch`` lanes with their
focal groups built on the host and padded to one group count, one rollout
per chunk on the card, and the metrics pooled over every chunk.
``eval.rollout_mode`` picks the rollout: "exact" (``run_closed_loop``, the
reference-parity default, kernel K3 on the card) or "streaming"
(``run_streaming``, kernels K1/K2).

Vehicle-selection modes (policy_evaluator.py:450-464):

- ``multi_agent``: <= 8 random moving vehicles per scene (random.sample)
- ``one_agent``: a random "interesting" vehicle — goal within 10 m of
  another's, goal timesteps within 2 s, both trajectories >= 60 steps
- ``two_agent``: an interesting *pair* by the same criteria
"""

from __future__ import annotations

import dataclasses
import random as pyrandom

import numpy as np
import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data.scenario import Scenario, stack_scenarios, to_torch
from ctrl_sim_tpu_torch.data.transforms import get_tilt_logits
from ctrl_sim_tpu_torch.device import resolve_device
from ctrl_sim_tpu_torch.evals.metrics import PolicyMetricsAccumulator
from ctrl_sim_tpu_torch.rollout.groups import GroupSpec, build_focal_groups, pad_groups
from ctrl_sim_tpu_torch.rollout.rollout import run_closed_loop
from ctrl_sim_tpu_torch.rollout.streaming import run_streaming


def check_streaming_normalization(cfg: Config) -> None:
    """Refuse a streaming evaluation of a model trained with window-anchored
    frames: the streaming rollout normalizes at episode start, so the model
    would see another input distribution than in training."""
    if (
        cfg.eval.rollout_mode == "streaming"
        and not cfg.waymo.episode_start_normalization
        and not cfg.eval.allow_normalization_mismatch
    ):
        raise ValueError(
            "eval.rollout_mode='streaming' evaluates with an "
            "episode-start normalization frame, but this config "
            "trains with window-anchored frames "
            "(waymo.episode_start_normalization=False) — the model "
            "would see a different input distribution than it was "
            "trained on. Either train/evaluate with "
            "waymo.episode_start_normalization=True, use "
            "eval.rollout_mode='exact', or acknowledge the mismatch "
            "with eval.allow_normalization_mismatch=True."
        )


def check_checkpoint_normalization(cfg: Config, ckpt_dir: str) -> None:
    """Cross-check a checkpoint's snapshotted training config (the port's
    ``config.json``, written by ``training/checkpoint.py``) against the
    eval config's normalization frame: the snapshot, not the eval-time
    flag, defines the distribution the model was trained on."""
    from ctrl_sim_tpu_torch.training.checkpoint import CheckpointManager

    try:
        train_cfg = CheckpointManager.load_config(ckpt_dir)
    except FileNotFoundError:
        print("[eval] warning: checkpoint has no config.json snapshot")
        return
    trained_esn = bool(train_cfg.get("waymo", {}).get("episode_start_normalization", False))
    if trained_esn != cfg.waymo.episode_start_normalization:
        raise SystemExit(
            f"checkpoint {ckpt_dir} was trained with "
            f"waymo.episode_start_normalization={trained_esn} but the "
            f"eval config sets {cfg.waymo.episode_start_normalization}"
            " — pass the matching -o waymo.episode_start_normalization"
            " override (the streaming rollout requires True)."
        )


def _moving_vehicle_ids(scene: Scenario) -> list[int]:
    """getObjectsThatMoved equivalent (scenario.cc:940-951)."""
    return [int(i) for i in np.where(scene.moving & scene.agent_valid)[0]]


def _interesting_candidates(cfg: Config, scene: Scenario, moving: list[int]) -> list[tuple[int, int]]:
    """The goal-proximity pairs (policy_evaluator.py:308-414)."""
    steps = cfg.sim.steps
    hist = cfg.eval.history_steps
    if len(moving) == 0:
        return []
    goals, goal_ts, long_enough = [], [], []
    for a in moving:
        valid = scene.traj_valid[a]
        idx_goal = steps - 1
        invalid = np.where(~valid)[0]
        if len(invalid) > 0:
            idx_goal = invalid[0] - 1
        goal_ts.append(idx_goal - hist)
        goals.append(scene.goal_position[a].copy())
        long_enough.append(1 if valid[hist:].sum() >= cfg.eval.interesting_traj_len_threshold else 0)
    goals = np.array(goals)
    goal_ts = np.array(goal_ts)
    long_enough = np.array(long_enough)
    dists = np.linalg.norm(goals[None] - goals[:, None], axis=-1)
    mask = (
        (dists < cfg.eval.interesting_goal_dist_threshold)
        & (dists > 0)
        & (long_enough[:, None] > 0)
        & (long_enough[None, :] > 0)
        & (np.abs(goal_ts[:, None] - goal_ts[None, :]) < cfg.eval.interesting_timestep_diff_threshold)
    )
    ii, jj = np.where(mask)
    return [(moving[i], moving[j]) for i, j in zip(ii, jj)]


def select_vehicles_to_evaluate(cfg: Config, scene: Scenario, rng: pyrandom.Random) -> list[int]:
    """The vehicles one scene evaluates under ``eval.eval_mode``, drawn
    from ``rng`` as the JAX evaluator draws them."""
    moving = _moving_vehicle_ids(scene)
    mode = cfg.eval.eval_mode
    if mode == "multi_agent":
        k = cfg.eval.multi_agent_eval_threshold
        if len(moving) > k:
            return rng.sample(moving, k)
        return moving
    pairs = _interesting_candidates(cfg, scene, moving)
    if not pairs:
        return []
    pair = rng.choice(pairs)
    if mode == "one_agent":
        return [pair[0]]
    return list(pair)


def rollout_fn(cfg: Config):
    """The rollout ``eval.rollout_mode`` names, after the normalization
    guard."""
    check_streaming_normalization(cfg)
    return run_streaming if cfg.eval.rollout_mode == "streaming" else run_closed_loop


def model_device(model: torch.nn.Module, device: torch.device | str | None) -> torch.device:
    """``device`` resolved (the card unless the caller passes "cpu"); the
    model's parameters must lie there."""
    dev = resolve_device(device)
    held = next(model.parameters()).device
    if held.type != dev.type:
        raise ValueError(f"the model lies on {held}, the evaluation runs on {dev}")
    return dev


class PolicyEvaluator:
    """Batched closed-loop evaluation over a scene set, on ``device`` (the
    card unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: Config, model, lane_batch: int = 32, device: torch.device | str | None = None):
        if cfg.model.ctg_plus_plus:
            raise NotImplementedError("the CTG++ closed-loop policy is not ported yet (ROADMAP.md §1 item 3)")
        self.cfg = cfg
        self.model = model
        self.lane_batch = lane_batch
        self.device = model_device(model, device)
        self._rollout = rollout_fn(cfg)
        tc = cfg.policy.tilt
        self.tilt_logits = get_tilt_logits(
            tc.goal_tilt if tc.tilt else 0.0,
            tc.veh_veh_tilt if tc.tilt else 0.0,
            tc.veh_edge_tilt if tc.tilt else 0.0,
            cfg.waymo, device=self.device,
        )

    def chunks(self, scenes: list[Scenario]) -> list[tuple[Scenario, np.ndarray, GroupSpec]]:
        """(stacked numpy scenes, controlled [E, A], focal groups) of every
        chunk: vehicles selected per scene (scenes with none are dropped),
        groups built per chunk and padded to the largest group count."""
        cfg = self.cfg
        rng = pyrandom.Random(cfg.eval.seed)
        selected = []
        for scene in scenes:
            vehicles = select_vehicles_to_evaluate(cfg, scene, rng)
            if vehicles:
                selected.append((scene, vehicles))
        # packed agent slots (eval.agent_slots) in the streaming rollout only
        crop = cfg.eval.agent_slots if cfg.eval.rollout_mode == "streaming" and cfg.eval.agent_slots else None
        out = []
        for i in range(0, len(selected), self.lane_batch):
            chunk = selected[i:i + self.lane_batch]
            batch = stack_scenarios([s for s, _ in chunk], cfg)
            controlled = np.zeros((len(chunk), batch.traj_position.shape[1]), dtype=bool)
            for e, (_, vehicles) in enumerate(chunk):
                controlled[e, vehicles] = True
            groups = build_focal_groups(
                cfg, np.asarray(batch.traj_position), np.asarray(batch.traj_valid).astype(bool),
                np.asarray(batch.agent_valid).astype(bool), controlled, crop_size=crop, device=self.device,
            )
            out.append((batch, controlled, groups))
        max_g = max((g.num_groups for _, _, g in out), default=1)
        return [(b, c, pad_groups(g, max_g)) for b, c, g in out]

    def rollout(self, batch: Scenario, controlled: np.ndarray, groups: GroupSpec,
                generator: torch.Generator | None, sampler=None):
        """One chunk's rollout on the evaluator's device."""
        sc = to_torch(dataclasses.replace(batch, name=""), self.device)
        return self._rollout(self.cfg, self.model, sc, torch.as_tensor(controlled, device=self.device),
                             generator, self.tilt_logits, groups=groups, sampler=sampler)

    def evaluate(self, scenes: list[Scenario], samplers: list | None = None) -> dict:
        """The Table-1 metrics over ``scenes`` ({} when no scene has a
        vehicle to evaluate). ``samplers[i]``, where given, replaces the
        policy's draws in chunk i (tests replay given draws through it)."""
        chunks = self.chunks(scenes)
        if not chunks:
            return {}
        generator = torch.Generator(device=self.device).manual_seed(self.cfg.eval.seed)
        acc = PolicyMetricsAccumulator(self.cfg)
        for i, (batch, controlled, groups) in enumerate(chunks):
            out = self.rollout(batch, controlled, groups, generator, samplers[i] if samplers else None)
            acc.update(out, batch)
        return acc.compute()
