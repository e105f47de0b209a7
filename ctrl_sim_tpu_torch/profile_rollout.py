"""Where the full-width streaming rollout's time goes, on the host and on
the device.

    python -m ctrl_sim_tpu_torch.profile_rollout

needs one CUDA card. Builds the full-width rollout set-up
(``rollout/setup.py``: 256 synthetic scenes, 90 steps, contacts on) and,
for each of its cases (the default family with the bf16 cache, kernel K1,
the int8 cache, kernel K2, and the bf16 cache with contacts off; DT, IL
and trajeglish, DT with the int8 cache, and the default family's
sequential 3-pass decode), runs one warm-up rollout, times ``RUNS``
rollouts, and runs one more under torch.profiler:
its device busy time (the sum of its kernels' times), the decode kernel's
share of it and the top kernels. The profiler slows the host, so only its
device times are read; the busy share is taken against the unprofiled
runs' median wall time.
"""

from __future__ import annotations

import statistics
import time

import torch

RUNS = 2  # timed rollouts per case, after one warm-up rollout


def _device_ms_by_kernel(prof) -> dict[str, float]:
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def profile_rollout(seed: int = 0) -> None:
    from torch.profiler import ProfilerActivity, profile

    from ctrl_sim_tpu_torch.rollout.setup import full_width_rollout
    from ctrl_sim_tpu_torch.rollout.streaming import run_streaming

    cfgs, models, sc, controlled, tilt = full_width_rollout(seed)

    def rollout(name):
        out = run_streaming(cfgs[name], models[name], sc, controlled,
                            torch.Generator(device="cuda").manual_seed(seed), tilt)
        torch.cuda.synchronize()
        if not torch.isfinite(out.position).all():
            raise AssertionError(f"{name}: non-finite positions")

    for name in cfgs:
        rollout(name)  # warm-up
        walls = []
        for _ in range(RUNS):
            start = time.perf_counter()
            rollout(name)
            walls.append(time.perf_counter() - start)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rollout(name)
        by_name = _device_ms_by_kernel(prof)
        busy_ms = sum(by_name.values())
        if busy_ms <= 0:
            raise RuntimeError("the profiler recorded no device time")
        wall_ms = statistics.median(walls) * 1e3
        decode_ms = sum(v for k, v in by_name.items() if "decode_attention" in k)
        print(f"[profile-rollout] {name}: wall {' '.join(f'{w:.3f}' for w in walls)} s (median {wall_ms:.1f} ms); "
              f"device busy {busy_ms:.1f} ms = {100 * busy_ms / wall_ms:.1f}% of the median wall; decode "
              f"attention kernels {decode_ms:.1f} ms = {100 * decode_ms / busy_ms:.1f}% of device time", flush=True)
        for kernel, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  {kernel[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the profile runs on the card only")
    profile_rollout()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
