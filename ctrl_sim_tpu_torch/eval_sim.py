"""Closed-loop policy evaluation entry point (port of
``ctrl_sim_tpu/eval_sim.py``; reference eval_sim.py): the Table-1 metrics.

  # a checkpoint of the port's trainer on 64 synthetic scenes, on the card
  python -m ctrl_sim_tpu_torch.eval_sim --ckpt checkpoints --synthetic 64 \\
      -o eval.eval_mode=multi_agent -o policy.tilt.goal_tilt=10

  # seeded random weights at a toy width, on the CPU
  python -m ctrl_sim_tpu_torch.eval_sim --device cpu --synthetic 4 \\
      -o model.hidden_dim=64 -o model.num_heads=4 -o sim.steps=16

  # scene JSONs (either dialect) with the converted trained checkpoint
  python -m ctrl_sim_tpu_torch.eval_sim --data_dir /data/test \\
      --ckpt artifacts/torch/r05_s0

Same flags as the JAX CLI, plus ``--device`` (``cuda`` by default; the run
raises without a card unless ``--device cpu`` is given). ``--ckpt``
restores the port's own checkpoints (``training/checkpoint.py``, the
``step_<n>.pt`` files of ``python -m ctrl_sim_tpu_torch.train``) and
starts from their ``config.json`` (the shapes and family they were
trained at) in place of the preset, before the overrides; without it the
weights are random from a seeded generator. ``--data_dir`` reads
every ``*.json`` scene of a directory (``--native_loader``: the C++
loader). Not ported yet, and refused: the CTG++ preset.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ctrl_sim_tpu_torch.config import Config, _set_dotted, preset
from ctrl_sim_tpu_torch.data.store import load_json_dir
from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario
from ctrl_sim_tpu_torch.device import resolve_device
from ctrl_sim_tpu_torch.evals.evaluator import PolicyEvaluator, check_checkpoint_normalization
from ctrl_sim_tpu_torch.train import parse_overrides
from ctrl_sim_tpu_torch.training import Trainer
from ctrl_sim_tpu_torch.training.checkpoint import checkpoint_config, restore_model


def add_common_flags(p: argparse.ArgumentParser) -> None:
    """The flags both evaluation CLIs take."""
    p.add_argument("--preset", default="ctrl_sim", help="the config without --ckpt (a checkpoint brings its own)")
    p.add_argument("-o", "--override", action="append", default=[])
    p.add_argument("--ckpt", default=None, help="checkpoint directory")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--limit_files", type=int, default=None)
    p.add_argument("--native_loader", action="store_true",
                   help="read --data_dir with the C++ loader (built with g++ at first use)")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--synthetic_agents", type=int, default=12)
    p.add_argument("--synthetic_conflict", type=int, default=0)
    p.add_argument("--synthetic_seed0", type=int, default=0,
                   help="first synthetic scene seed (held-out evals use an "
                        "offset disjoint from the training corpus seeds)")
    p.add_argument("--lane_batch", type=int, default=32)
    p.add_argument("--out", default=None, help="write the metrics JSON here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def config_and_scenes(args) -> tuple[Config, list]:
    """The checkpoint's config (``--ckpt``) or the preset, with the
    overrides, and the scenes to evaluate."""
    overrides = parse_overrides(args.override)
    if args.ckpt:
        cfg = checkpoint_config(args.ckpt, overrides)
    else:
        cfg = preset(args.preset)
        for key, value in overrides.items():
            cfg = _set_dotted(cfg, key, value)
    if args.data_dir:
        return cfg, load_json_dir(cfg, args.data_dir, args.limit_files, native=args.native_loader)
    scenes = [
        synthetic_scenario(cfg, seed=args.synthetic_seed0 + s, num_agents=args.synthetic_agents,
                           conflict_pairs=args.synthetic_conflict)
        for s in range(args.synthetic or 8)
    ]
    return cfg, scenes


def load_model(cfg: Config, args, device: torch.device, tag: str = "eval"):
    """The model, with seeded random weights or restored from ``--ckpt``
    (the latest step unless ``--ckpt_step``), in eval mode."""
    if args.ckpt:
        # the snapshotted training config, not the eval-time flag, defines
        # the distribution the model was trained on
        check_checkpoint_normalization(cfg, args.ckpt)
        model, step = restore_model(cfg, args.ckpt, device, step=getattr(args, "ckpt_step", None))
        print(f"[{tag}] restored step {step} from {args.ckpt}")
        return model
    model = Trainer(cfg, device=device).init_state(torch.Generator().manual_seed(0)).model
    model.eval()
    return model


def write_metrics(metrics: dict, path: str | None) -> None:
    print(json.dumps(metrics, indent=2))
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(metrics, f, indent=2)
        print(f"[eval] wrote {path}")


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    add_common_flags(p)
    p.add_argument("--ckpt_step", type=int, default=None,
                   help="restore this saved step instead of the latest "
                        "(learning-curve evals)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg, scenes = config_and_scenes(args)
    if cfg.model.ctg_plus_plus:
        raise NotImplementedError("the CTG++ closed-loop policy is not ported yet (ROADMAP.md §1 item 3)")
    model = load_model(cfg, args, device)
    evaluator = PolicyEvaluator(cfg, model, lane_batch=args.lane_batch, device=device)
    metrics = evaluator.evaluate(scenes)
    write_metrics(metrics, args.out)
    return metrics


if __name__ == "__main__":
    main()
