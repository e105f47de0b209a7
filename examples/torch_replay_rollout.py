"""Canonical end-to-end slice on the PyTorch port: synthetic scenes ->
batched env -> 90-step replay through physics (the data-generation
semantics of reference data/generate_offline_rl_dataset.py), with the
contact solver on, and the replay's ADE against the ground-truth log.

The port's counterpart of ``examples/replay_rollout.py``. Run from the repo
root, on the card (default) or the CPU:
    python examples/torch_replay_rollout.py
    python examples/torch_replay_rollout.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from ctrl_sim_tpu_torch.config import load_config  # noqa: E402
from ctrl_sim_tpu_torch.data import stack_scenarios, synthetic_scenario, to_torch  # noqa: E402
from ctrl_sim_tpu_torch.data.datagen import generate_offline_data  # noqa: E402
from ctrl_sim_tpu_torch.device import resolve_device  # noqa: E402


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--scenes", type=int, default=4)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config({})
    scenes = [synthetic_scenario(cfg, seed=s, num_agents=4, arena_half=120.0, num_lanes=2)
              for s in range(args.scenes)]
    batch = to_torch(stack_scenarios(scenes, cfg), device)

    def run():
        out = generate_offline_data(cfg, batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out

    run()  # warm-up (the card builds nothing here; its first launches are slower)
    t0 = time.perf_counter()
    out = run()
    dt = time.perf_counter() - t0

    # replay-through-physics fidelity: simulated positions vs GT log
    gt = batch.traj_position[:, :, : cfg.sim.steps]
    sim = out.states[..., :2]  # [E, A, T, 2]
    valid = batch.traj_valid[:, :, : cfg.sim.steps] & (out.states[..., 7] > 0)
    ade = float(torch.sqrt(((sim - gt) ** 2).sum(-1))[valid].mean())

    rew = out.rewards8  # [E, A, T, 8]
    pos_achieved = float(rew[..., 0].sum())
    veh_veh = float(rew[..., 6].sum())
    veh_edge = float(rew[..., 7].sum())

    print(f"steady-state {cfg.sim.steps}-step replay over {args.scenes} envs on {device.type}: {dt * 1e3:.1f} ms")
    print(f"replay ADE vs GT: {ade:.4f} m")
    print(f"sticky position_achieved count: {pos_achieved:.0f}")
    print(f"veh_veh events: {veh_veh:.0f}  veh_edge events: {veh_edge:.0f}")

    assert ade < 0.15, "replay drift too large"
    assert pos_achieved > 0, "no goals achieved during replay"
    print("OK")


if __name__ == "__main__":
    main()
