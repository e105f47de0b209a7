"""Training entry point: ``python -m ctrl_sim_tpu_torch.train`` (port of
``ctrl_sim_tpu/train.py``, same flags and output lines).

argparse + dotted config overrides, one device (the card unless
``--device cpu``), checkpoints with auto-resume. The scenes are replayed
through physics with the contact solver on (``sim.resolve_contacts``).
Each step's batch and dropout draws come from generators seeded by
(``train.seed``, step), so a resumed run draws what an uninterrupted one
draws, and the grad-norm logging draws from a stream of its own.

Examples:
  # smoke-train on synthetic scenes at a toy width, on the CPU
  python -m ctrl_sim_tpu_torch.train --synthetic 8 --steps 3 --device cpu \\
      -o model.hidden_dim=64 -o model.num_heads=4 \\
      -o train.global_batch_size=4 --log_every 1 --save_dir /tmp/ckpt

  # full width on the card, global batch 64 as 16 x 4 accumulation
  python -m ctrl_sim_tpu_torch.train --synthetic 64 --steps 200 -o train.accum_steps=4

  # offline-RL training on directories of scene JSONs, validated every 1000 steps
  python -m ctrl_sim_tpu_torch.train --data_dir /data/offline_rl/train \\
      --val_dir /data/offline_rl/val --val_every 1000 --steps 200000

``--preset`` picks the model family: ``ctrl_sim`` (the default), ``dt``,
``il`` or ``trajeglish``, each trained on the CtRL-Sim batch. With
``--val_dir`` and ``--val_every``, every ``val_every`` steps the loss of a
batch of the validation scenes (drawn by a stream of its own) is printed
as ``[val] step=... val_loss=...``, logged, and saved with that step's
checkpoint, and the checkpoint with the lowest ``val_loss`` is kept beside
the last ``train.keep_last_n``. ``--native_loader`` reads the JSONs with
the C++ loader. Not ported yet, and refused: ``--preset ctg_plus_plus``,
``--distributed`` (the multi-device learner).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ctrl_sim_tpu_torch.config import Config, _set_dotted, preset
from ctrl_sim_tpu_torch.data.store import ScenarioStore
from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario
from ctrl_sim_tpu_torch.device import resolve_device
from ctrl_sim_tpu_torch.training import Trainer
from ctrl_sim_tpu_torch.training.checkpoint import CheckpointManager
from ctrl_sim_tpu_torch.training.trainer import (
    DATA_STREAM,
    DROPOUT_STREAM,
    GRAD_NORM_STREAM,
    VAL_STREAM,
    step_generator,
)
from ctrl_sim_tpu_torch.utils.logging import MetricsLogger


def parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        try:
            parsed = json.loads(value)
        except json.JSONDecodeError:
            parsed = value
        out[key] = parsed
    return out


def build_store(cfg: Config, args, device: torch.device) -> ScenarioStore:
    if args.data_dir:
        return ScenarioStore.from_json_dir(cfg, args.data_dir, limit=args.limit_files, device=device,
                                           native=args.native_loader)
    scenes = [
        synthetic_scenario(cfg, seed=s, num_agents=args.synthetic_agents,
                           conflict_pairs=args.synthetic_conflict)
        for s in range(args.synthetic)
    ]
    return ScenarioStore.from_scenes(cfg, scenes, device=device)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="ctrl_sim")
    p.add_argument("-o", "--override", action="append", default=[])
    p.add_argument("--data_dir", default=None)
    p.add_argument("--val_dir", default=None)
    p.add_argument("--limit_files", type=int, default=None)
    p.add_argument("--native_loader", action="store_true",
                   help="read --data_dir / --val_dir with the C++ loader (built with g++ at first use)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic scenes when no data_dir")
    p.add_argument("--synthetic_agents", type=int, default=12)
    p.add_argument("--synthetic_conflict", type=int, default=0,
                   help="crossing-course agent pairs per synthetic scene "
                        "(collision-diverse corpus for RTG tilting)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--val_every", type=int, default=None)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--distributed", action="store_true",
                   help="multi-device training (not ported yet)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.distributed:
        raise NotImplementedError("--distributed: the multi-device learner is not ported yet")
    device = resolve_device(args.device)

    cfg = preset(args.preset)
    overrides = parse_overrides(args.override)
    if args.steps:
        overrides["train.max_steps"] = args.steps
    for key, value in overrides.items():
        cfg = _set_dotted(cfg, key, value)

    batch_size = cfg.train.global_batch_size
    print(f"[train] devices=1 batch={batch_size} preset={args.preset}")
    store = build_store(cfg, args, device)
    print(f"[train] store: {store.num_scenes} scenes")
    val_store = None
    if args.val_dir:
        val_store = ScenarioStore.from_json_dir(cfg, args.val_dir, limit=args.limit_files, device=device,
                                                native=args.native_loader)
        print(f"[train] validation store: {val_store.num_scenes} scenes")

    seed = cfg.train.seed
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(seed))

    save_dir = args.save_dir or cfg.train.save_dir
    mgr = CheckpointManager(cfg, save_dir)
    if mgr.latest_step() is not None:
        print(f"[train] resuming from step {mgr.latest_step()}")
        state = mgr.restore(state)

    logger = MetricsLogger(save_dir, track=cfg.train.track)
    train_step = trainer.make_train_step()
    eval_step = trainer.make_eval_step()
    grad_norm_fn = trainer.make_grad_norm_fn() if cfg.train.log_grad_norms else None

    t0 = time.time()
    step = state.step
    while step < cfg.train.max_steps:
        batch = store.sample_batch(step_generator(seed, step, DATA_STREAM, device), batch_size)
        state, losses = train_step(state, batch, step_generator(seed, step, DROPOUT_STREAM, device))
        step = state.step
        if step % args.log_every == 0:
            total = float(losses.total)
            dt = time.time() - t0
            t0 = time.time()
            row = {k: float(v) for k, v in losses._asdict().items()}
            row["steps_per_sec"] = args.log_every / dt
            if grad_norm_fn is not None:
                gen = step_generator(seed, step, GRAD_NORM_STREAM, device)
                row.update({k: float(v) for k, v in grad_norm_fn(state, batch, gen).items()})
            logger.log(step, row)
            print(
                f"[train] step={step} loss={total:.4f} "
                f"actions={float(losses.loss_actions):.4f} "
                f"rtg={float(losses.loss_rtg_goal):.4f}/"
                f"{float(losses.loss_rtg_veh):.4f}/"
                f"{float(losses.loss_rtg_road):.4f} "
                f"state={float(losses.loss_state):.4f} "
                f"steps/s={args.log_every / dt:.2f}"
            )
        if args.val_every and val_store is not None and step % args.val_every == 0:
            vb = val_store.sample_batch(step_generator(seed, step, VAL_STREAM, device), batch_size)
            val_metric = float(eval_step(state, vb).total)
            print(f"[val] step={step} val_loss={val_metric:.4f}")
            logger.log(step, {"val_loss": val_metric})
            mgr.save(step, state, metrics={"val_loss": val_metric})
        elif step % args.ckpt_every == 0:
            mgr.save(step, state)
    mgr.save(step, state)
    mgr.wait()
    logger.close()
    print(f"[train] done at step {step}; checkpoints in {save_dir}")


if __name__ == "__main__":
    main()
