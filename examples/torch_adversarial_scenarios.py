"""Adversarial scenario generation on the PyTorch port: make a tilted
agent attack the planner.

The port's counterpart of ``examples/adversarial_scenarios.py``: picks an
(ego, adversary) pair per scene, drives the ego with the positively tilted
planner policy and the adversary with a negatively veh-veh-tilted policy
(reference: evaluators/planner_adversary_evaluator.py:134-152), on the
trained round-5 checkpoint converted for the port
(``artifacts/torch/r05_s0``), with the streaming rollout (kernel K1 on the
card). Evaluates crossing-course conflict scenes at the reference's
adversary tilt (-10) and a stronger one (-50), and prints the Table-2
safety metrics: ego collision rate with the adversary, the adversary's
speed at impact, and its distribution shift (JSD against ground truth).

Run from the repo root, on the card (default) or the CPU:
    python examples/torch_adversarial_scenarios.py
    python examples/torch_adversarial_scenarios.py --device cpu --scenes 4
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ctrl_sim_tpu_torch.config import TiltConfig  # noqa: E402
from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario  # noqa: E402
from ctrl_sim_tpu_torch.device import resolve_device  # noqa: E402
from ctrl_sim_tpu_torch.evals.planner_adversary import PlannerAdversaryEvaluator  # noqa: E402
from ctrl_sim_tpu_torch.training.checkpoint import checkpoint_config, restore_model  # noqa: E402

CKPT = os.path.join(REPO, "artifacts", "torch", "r05_s0")

# the checkpoint's own config (its training shapes, tools/make_r05_artifacts.py)
# + the streaming decode and the planner-adversary knobs: conflict scenes are
# 40 steps, so the "interesting pair" thresholds relax from their
# Waymo-episode-scale defaults
OVERRIDES = {
    "eval.rollout_mode": "streaming",
    "eval.interesting_traj_len_threshold": 20,
    "eval.interesting_timestep_diff_threshold": 5,
    "eval.interesting_goal_dist_threshold": 1000.0,
}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--scenes", type=int, default=16)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = checkpoint_config(CKPT, OVERRIDES)
    # crossing-course conflict pairs give the adversary something to hit
    scenes = [synthetic_scenario(cfg, seed=3000 + s, num_agents=8, conflict_pairs=2) for s in range(args.scenes)]
    model, step = restore_model(cfg, CKPT, device)
    print(f"restored step {step} from {CKPT}")

    print(f"{'adversary tilt':>14s} {'ego CR w/adv':>12s} {'adv impact m/s':>14s} {'adv lin JSD':>11s}")
    for tilt in (-10.0, -50.0):
        ev = PlannerAdversaryEvaluator(cfg, model, adversary_tilt=TiltConfig(veh_veh_tilt=tilt), lane_batch=16,
                                       device=device)
        m = ev.evaluate(scenes)
        print(f"{tilt:14.0f} {m['ego_cr_w_adv']:12.3f} {m['adv_coll_speed']:14.2f} {m['adv_lin_jsd']:11.3f}")
    print("the negatively tilted adversary collides with the ego at speed; "
          "feed the collision scenes to data/finetune.py (CAT mixing) to "
          "harden the planner")


if __name__ == "__main__":
    main()
