"""Planner-vs-adversary evaluation entry point (port of
``ctrl_sim_tpu/eval_planner.py``; reference eval_planner.py): the Table-2
metrics.

  python -m ctrl_sim_tpu_torch.eval_planner --ckpt checkpoints --synthetic 64
  python -m ctrl_sim_tpu_torch.eval_planner --device cpu --synthetic 4 \\
      -o model.hidden_dim=64 -o model.num_heads=4 -o sim.steps=16

Same flags as the JAX CLI, plus ``--device`` (``cuda`` by default). The
checkpoints, the seeded weights and what is refused are as in
``eval_sim``.
"""

from __future__ import annotations

import argparse

from ctrl_sim_tpu_torch.config import TiltConfig
from ctrl_sim_tpu_torch.device import resolve_device
from ctrl_sim_tpu_torch.eval_sim import add_common_flags, config_and_scenes, load_model, write_metrics
from ctrl_sim_tpu_torch.evals.planner_adversary import PlannerAdversaryEvaluator


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    add_common_flags(p)
    # planner/adversary tilts (cfgs/policy/ctrl_sim_planner|_adversary.yaml)
    p.add_argument("--planner_tilt", nargs=3, type=float, default=[10.0, 10.0, 10.0],
                   metavar=("GOAL", "VEH", "EDGE"))
    p.add_argument("--adversary_tilt", nargs=3, type=float, default=[0.0, -10.0, 0.0],
                   metavar=("GOAL", "VEH", "EDGE"))
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg, scenes = config_and_scenes(args)
    model = load_model(cfg, args, device, tag="eval_planner")
    pt = TiltConfig(goal_tilt=args.planner_tilt[0], veh_veh_tilt=args.planner_tilt[1],
                    veh_edge_tilt=args.planner_tilt[2])
    at = TiltConfig(goal_tilt=args.adversary_tilt[0], veh_veh_tilt=args.adversary_tilt[1],
                    veh_edge_tilt=args.adversary_tilt[2])
    evaluator = PlannerAdversaryEvaluator(cfg, model, planner_tilt=pt, adversary_tilt=at,
                                          lane_batch=args.lane_batch, device=device)
    metrics = evaluator.evaluate(scenes)
    write_metrics(metrics, args.out)
    return metrics


if __name__ == "__main__":
    main()
