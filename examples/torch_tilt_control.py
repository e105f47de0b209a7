"""Controllability demo on the PyTorch port: steer a trained policy with
exponential tilting.

The port's counterpart of ``examples/tilt_control.py``: loads the trained
round-5 checkpoint converted for the port (``artifacts/torch/r05_s0``,
26k steps on the collision-diverse synthetic corpus; see
``tools/convert_checkpoints_to_torch.py``), rolls the same held-out scenes
under three veh-veh tilt settings with the streaming rollout (its decode
attention is kernel K1 on the card), and prints the dose-response table:
positive tilts push the sampled return-to-go bins toward "high veh-veh
return" (safe, close-to-GT driving), negative tilts toward "low return".

Run from the repo root, on the card (default) or the CPU:
    python examples/torch_tilt_control.py
    python examples/torch_tilt_control.py --device cpu --scenes 4
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario  # noqa: E402
from ctrl_sim_tpu_torch.data.transforms import get_tilt_logits  # noqa: E402
from ctrl_sim_tpu_torch.device import resolve_device  # noqa: E402
from ctrl_sim_tpu_torch.evals.evaluator import PolicyEvaluator  # noqa: E402
from ctrl_sim_tpu_torch.training.checkpoint import checkpoint_config, restore_model  # noqa: E402

CKPT = os.path.join(REPO, "artifacts", "torch", "r05_s0")

# the checkpoint's own config (its training shapes, tools/make_r05_artifacts.py),
# rolled out with the streaming decode
STREAMING = {"eval.rollout_mode": "streaming"}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--scenes", type=int, default=16)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = checkpoint_config(CKPT, STREAMING)
    scenes = [synthetic_scenario(cfg, seed=2000 + s, num_agents=8) for s in range(args.scenes)]
    model, step = restore_model(cfg, CKPT, device)
    print(f"restored step {step} from {CKPT}")

    ev = PolicyEvaluator(cfg, model, lane_batch=16, device=device)
    print(f"{'veh_veh_tilt':>12s} {'goal':>6s} {'CR':>7s} {'ADE':>6s}")
    for tilt in (-50.0, 0.0, 10.0):
        ev.tilt_logits = get_tilt_logits(0.0, tilt, 0.0, cfg.waymo, device=device)
        m = ev.evaluate(scenes)
        print(f"{tilt:12.0f} {m['goal']:6.3f} {m['collision_rate']:7.4f} {m['ade']:6.3f}")
    print("negative tilt -> the policy degrades monotonically; "
          "positive -> tighter, safer driving (Fig-4 semantics)")


if __name__ == "__main__":
    main()
