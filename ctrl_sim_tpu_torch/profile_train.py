"""Where the full-width train step's device time goes, by kernel.

    python -m ctrl_sim_tpu_torch.profile_train [--steps 3]

needs one CUDA card. Builds the full-width training set-up (the default
model with dropout 0.1, 64 synthetic scenes of 12 agents replayed through
physics with contacts on, global batch 64 as 16 x 4 accumulation), runs two
warm-up steps and then ``--steps`` steps under torch.profiler, and prints
the device time by kernel (top 25), the share of the flash kernels (K3/K4)
and the device's busy share of the window's wall time. The profiler slows
the host, so the window's ms per step exceeds an unprofiled step's.
"""

from __future__ import annotations

import argparse
import time

import torch

SCENES, AGENTS, ARENA, LANE_ROADS = 64, 12, 300.0, 4  # bench.py's scene recipe


def full_width_setup(seed: int = 0, family: str = "ctrl_sim", store=None):
    """The full-width training set-up of a model family (``config.preset``)
    on the card. Returns (cfg, store, state, train_step, data_gen,
    dropout_gen, replay_s), replay_s being the seconds the store's replay
    through physics took; a ``store`` given (every family trains on the
    same CtRL-Sim batches) is used as it is, and replay_s is 0."""
    from ctrl_sim_tpu_torch.config import _set_dotted, preset
    from ctrl_sim_tpu_torch.data import synthetic_scenario
    from ctrl_sim_tpu_torch.data.store import ScenarioStore
    from ctrl_sim_tpu_torch.training import Trainer

    cfg = _set_dotted(preset(family), "train.accum_steps", 4)
    replay_s = 0.0
    if store is None:
        scenes = [synthetic_scenario(cfg, seed=s, num_agents=AGENTS, arena_half=ARENA, num_lanes=LANE_ROADS)
                  for s in range(SCENES)]
        torch.cuda.synchronize()
        start = time.perf_counter()
        store = ScenarioStore.from_scenes(cfg, scenes)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - start
    trainer = Trainer(cfg)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    data_gen = torch.Generator(device="cuda").manual_seed(seed)
    dropout_gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    return cfg, store, state, trainer.make_train_step(), data_gen, dropout_gen, replay_s


def profile_train(steps: int = 3) -> None:
    from torch.profiler import ProfilerActivity, profile

    cfg, store, state, train_step, data_gen, dropout_gen, _ = full_width_setup()
    for _ in range(2):
        state, _ = train_step(state, store.sample_batch(data_gen, cfg.train.global_batch_size), dropout_gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            state, _ = train_step(state, store.sample_batch(data_gen, cfg.train.global_batch_size), dropout_gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    flash_ms = sum(v for k, v in by_name.items() if "flash_" in k)
    print(f"[profile-train] {steps} steps, wall {wall_ms:.1f} ms ({wall_ms / steps:.1f} per step); device busy "
          f"{busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% of wall; K3/K4 kernels {flash_ms:.1f} ms = "
          f"{100 * flash_ms / busy_ms:.1f}% of device time")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {ms / steps:9.3f} ms/step {100 * ms / busy_ms:5.1f}%  {name[:110]}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3, help="profiled train steps, after two warm-up steps")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the profile runs on the card only")
    profile_train(args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
