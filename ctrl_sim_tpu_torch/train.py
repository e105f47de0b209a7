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
``il`` or ``trajeglish``, each trained on the CtRL-Sim batch, or
``ctg_plus_plus``, the diffusion baseline (``CTGTrainer`` on CTG++ batches,
lr 2e-4, accumulation 2; its lines print the diffusion, first-action and
RTG losses, and it logs no gradient norms). With ``--val_dir`` and
``--val_every``, every ``val_every`` steps the loss of a batch of the
validation scenes (drawn by a stream of its own) is printed as ``[val]
step=... val_loss=...`` (CTG++: ``state_mse=... action_mse=...`` of
sampled futures, and ``state_mse`` selects), logged, and saved with that
step's checkpoint, and the checkpoint with the lowest ``val_loss`` is kept
beside the last ``train.keep_last_n``. ``--native_loader`` reads the JSONs
with the C++ loader.

``--distributed`` trains data parallel, one process per card, started by
torchrun (the JAX package runs one process over all local chips):

  torchrun --nproc_per_node 8 -m ctrl_sim_tpu_torch.train --distributed --synthetic 64

Each rank joins the process group of torchrun's environment (NCCL; gloo
with ``--device cpu``) on ``cuda:LOCAL_RANK``, the global batch is rounded
down to a multiple of the world size, every rank samples the same global
batch and draws from the same generators, and the trainer splits each
microbatch over the ranks and all-reduces the losses' mask sums and the
gradients (``training/trainer.py``). Rank 0 alone prints, logs and writes
checkpoints, with a barrier around each save; every rank restores, and the
validation losses are reduced over the ranks.
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
from ctrl_sim_tpu_torch.parallel import MeshSpec, init_distributed, make_mesh
from ctrl_sim_tpu_torch.training import trainer_for
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
                   help="data-parallel training over torchrun's processes, one per card")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.distributed:
        device = init_distributed(device=args.device)
        mesh = make_mesh()
    else:
        device, mesh = resolve_device(args.device), MeshSpec()
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)

    cfg = preset(args.preset)
    overrides = parse_overrides(args.override)
    if args.steps:
        overrides["train.max_steps"] = args.steps
    for key, value in overrides.items():
        cfg = _set_dotted(cfg, key, value)

    batch_size = cfg.train.global_batch_size
    if batch_size % mesh.world:
        batch_size = max(mesh.world, batch_size - batch_size % mesh.world)
        say(f"[train] rounding global batch to {batch_size} for {mesh.world} devices")
    say(f"[train] devices={mesh.world} batch={batch_size} preset={args.preset}")
    store = build_store(cfg, args, device)
    say(f"[train] store: {store.num_scenes} scenes")
    val_store = None
    if args.val_dir:
        val_store = ScenarioStore.from_json_dir(cfg, args.val_dir, limit=args.limit_files, device=device,
                                                native=args.native_loader)
        say(f"[train] validation store: {val_store.num_scenes} scenes")

    seed = cfg.train.seed
    is_ctg = cfg.model.ctg_plus_plus
    family = "ctg_plus_plus" if is_ctg else "ctrl_sim"
    trainer = trainer_for(cfg, device=device, mesh=mesh)
    state = trainer.init_state(torch.Generator().manual_seed(seed))

    save_dir = args.save_dir or cfg.train.save_dir
    mgr = CheckpointManager(cfg, save_dir) if lead else None  # rank 0 writes config.json first
    mesh.barrier()
    mgr = mgr or CheckpointManager(cfg, save_dir)
    if mgr.latest_step() is not None:
        say(f"[train] resuming from step {mgr.latest_step()}")
        state = mgr.restore(state)

    def save(step: int, **kw) -> None:
        mesh.barrier()
        if lead:
            mgr.save(step, state, **kw)
        mesh.barrier()

    logger = MetricsLogger(save_dir, track=cfg.train.track) if lead else None
    train_step = trainer.make_train_step()
    eval_step = trainer.make_eval_step()
    grad_norm_fn = trainer.make_grad_norm_fn() if cfg.train.log_grad_norms and not is_ctg else None

    t0 = time.time()
    step = state.step
    while step < cfg.train.max_steps:
        batch = store.sample_batch(step_generator(seed, step, DATA_STREAM, device), batch_size, family=family)
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
            if lead:
                logger.log(step, row)
            if is_ctg:
                say(
                    f"[train] step={step} loss={total:.4f} "
                    f"diffusion={float(losses.diffusion_loss):.4f} "
                    f"a0={float(losses.a0_loss):.4f} "
                    f"rtg={float(losses.rtg_goal):.4f}/"
                    f"{float(losses.rtg_veh):.4f}/"
                    f"{float(losses.rtg_road):.4f} "
                    f"steps/s={args.log_every / dt:.2f}"
                )
            else:
                say(
                    f"[train] step={step} loss={total:.4f} "
                    f"actions={float(losses.loss_actions):.4f} "
                    f"rtg={float(losses.loss_rtg_goal):.4f}/"
                    f"{float(losses.loss_rtg_veh):.4f}/"
                    f"{float(losses.loss_rtg_road):.4f} "
                    f"state={float(losses.loss_state):.4f} "
                    f"steps/s={args.log_every / dt:.2f}"
                )
        if args.val_every and val_store is not None and step % args.val_every == 0:
            val_gen = step_generator(seed, step, VAL_STREAM, device)
            vb = val_store.sample_batch(val_gen, batch_size, family=family)
            if is_ctg:
                # checkpoint selection by state_mse (the reference train.py:38-46 monitor)
                vm = eval_step(state, vb, val_gen)
                val_metric = float(vm["state_mse"])
                say(f"[val] step={step} state_mse={val_metric:.4f} action_mse={float(vm['action_mse']):.4f}")
            else:
                val_metric = float(eval_step(state, vb).total)
                say(f"[val] step={step} val_loss={val_metric:.4f}")
            if lead:
                logger.log(step, {"val_loss": val_metric})
            save(step, metrics={"val_loss": val_metric})
        elif step % args.ckpt_every == 0:
            save(step)
    save(step)
    mgr.wait()
    if lead:
        logger.close()
    say(f"[train] done at step {step}; checkpoints in {save_dir}")
    if args.distributed:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
