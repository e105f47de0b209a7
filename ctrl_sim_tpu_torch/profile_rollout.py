"""Where the full-width rollouts' time goes, on the host and on the device.

    python -m ctrl_sim_tpu_torch.profile_rollout

needs one CUDA card. Builds the full-width rollout set-ups
(``rollout/setup.py``) and, for each case, runs one warm-up rollout, times
``RUNS`` rollouts, and runs one more under torch.profiler: its device busy
time (the sum of its kernels' times), its attention kernel's share of it
and the top kernels. The streaming cases (256 synthetic scenes, 90 steps,
contacts on): the default family with the bf16 cache, kernel K1, the int8
cache, kernel K2, and the bf16 cache with contacts off; DT, IL and
trajeglish, DT with the int8 cache, and the default family's sequential
3-pass decode. The exact case: one 32-scene chunk of the exact-mode
evaluation (``PolicyEvaluator`` in multi_agent mode), whose decodes are
full forwards through kernel K3. The observe case: ``observation_replay``
(``env/gym.py``) over the same 32 scenes, 90 steps, contacts on, which
reaches no kernel; its line also gives the seconds of ``WaymoEnv.observe``
in one more run, each call synchronized (``utils/profiling.StepMeter``).
The profiler slows the host, so only its device times are read; the busy
share is taken against the unprofiled runs' median wall time.
"""

from __future__ import annotations

import statistics
import time
from types import SimpleNamespace

import torch

RUNS = 2  # timed rollouts per case, after one warm-up rollout


def _device_ms_by_kernel(prof) -> dict[str, float]:
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def _cases(seed: int):
    """(name, rollout, attention kernel name) of every case: each rollout
    is a function that runs one chunk and returns its output."""
    from ctrl_sim_tpu_torch.data import stack_scenarios, to_torch
    from ctrl_sim_tpu_torch.env.gym import observation_replay
    from ctrl_sim_tpu_torch.evals.evaluator import PolicyEvaluator
    from ctrl_sim_tpu_torch.rollout.setup import exact_eval_setup, full_width_rollout
    from ctrl_sim_tpu_torch.rollout.streaming import run_streaming

    cfgs, models, sc, controlled, tilt = full_width_rollout(seed)
    for name in cfgs:
        yield name, lambda name=name: run_streaming(cfgs[name], models[name], sc, controlled,
                                                    torch.Generator(device="cuda").manual_seed(seed), tilt), \
            "decode_attention"
    del cfgs, models, sc
    cfg, model, scenes = exact_eval_setup(seed)
    ev = PolicyEvaluator(cfg, model)
    (chunk,) = ev.chunks(scenes)
    yield "exact", lambda: ev.rollout(*chunk, torch.Generator(device="cuda").manual_seed(seed)), "flash_fwd"
    del ev, model, chunk
    sc = to_torch(stack_scenarios(scenes, cfg), "cuda")
    ego = torch.zeros(sc.traj_position.shape[0], dtype=torch.long, device="cuda")
    yield "observe", lambda: SimpleNamespace(position=observation_replay(cfg, sc, ego)[1]["position"]), None


def _observe_seconds(rollout) -> float:
    """Seconds of ``WaymoEnv.observe`` in one rollout, each call timed up
    to its device's completion."""
    from ctrl_sim_tpu_torch.env.env import WaymoEnv
    from ctrl_sim_tpu_torch.utils import StepMeter

    meter, orig = StepMeter(), WaymoEnv.observe

    def observe(env, scenario, state, *args, **kwargs):
        torch.cuda.synchronize()
        with meter.phase("observe", materialize=state.bodies.position):  # waits for the device at the end
            return orig(env, scenario, state, *args, **kwargs)

    WaymoEnv.observe = observe
    try:
        rollout()
    finally:
        WaymoEnv.observe = orig
    return meter.totals["observe"]


def profile_rollout(seed: int = 0) -> None:
    from torch.profiler import ProfilerActivity, profile

    for name, run, kernel_key in _cases(seed):
        def rollout():
            out = run()
            torch.cuda.synchronize()
            if not torch.isfinite(out.position).all():
                raise AssertionError(f"{name}: non-finite positions")

        rollout()  # warm-up
        walls = []
        for _ in range(RUNS):
            start = time.perf_counter()
            rollout()
            walls.append(time.perf_counter() - start)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rollout()
        by_name = _device_ms_by_kernel(prof)
        busy_ms = sum(by_name.values())
        if busy_ms <= 0:
            raise RuntimeError("the profiler recorded no device time")
        wall_ms = statistics.median(walls) * 1e3
        if kernel_key is None:
            share = f"WaymoEnv.observe {_observe_seconds(rollout):.3f} s of one more run"
        else:
            attn_ms = sum(v for k, v in by_name.items() if kernel_key in k)
            share = f"{kernel_key} kernels {attn_ms:.1f} ms = {100 * attn_ms / busy_ms:.1f}% of device time"
        print(f"[profile-rollout] {name}: wall {' '.join(f'{w:.3f}' for w in walls)} s (median {wall_ms:.1f} ms); "
              f"device busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% of the median wall; {share}",
              flush=True)
        for kernel, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  {kernel[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the profile runs on the card only")
    profile_rollout()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
