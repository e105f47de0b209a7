"""The idle share of one traced window, counted twice: as the benchmark's
``device_idle_pct.*`` readers count it (the union of the profiler's device
operation intervals over the window) and by hand from the exported Chrome
trace (every microsecond of the window marked busy or not).

    python3 -m benchmark.check_idle --workload NAME --seed N --seconds S --out TRACE.json

Runs on the card; prints one JSON line with both shares.
"""

from __future__ import annotations

import argparse
import importlib
import json

import numpy as np

from benchmark import harness
from benchmark.trace import DeviceTrace, Spans

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def hand_count(trace_json: dict, lo_ns: int, hi_ns: int) -> float:
    """Busy seconds of [lo, hi) from the Chrome trace's device events, on
    a microsecond grid."""
    base = int(trace_json.get("baseTimeNanoseconds", 0))
    lo_us, hi_us = (lo_ns - base) / 1e3, (hi_ns - base) / 1e3
    grid = np.zeros(int(np.ceil(hi_us - lo_us)) + 1, dtype=bool)
    for ev in trace_json["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            a = max(int(round(ev["ts"] - lo_us)), 0)
            b = min(int(round(ev["ts"] + ev["dur"] - lo_us)), len(grid))
            if b > a:
                grid[a:b] = True
    return grid.sum() / 1e6


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    bench = harness.manifest()
    cell = harness.cell(bench, args.workload)
    traffic = harness.traffic_file(cell["traffic"])
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    run = driver.Run(harness.config_file(bench, cell["config"]), traffic, args.seed)
    trace = DeviceTrace(export=args.out)
    run.measure(args.seconds, Spans(), trace)
    with open(args.out) as f:
        busy_hand = hand_count(json.load(f), trace.lo, trace.hi)
    print(json.dumps({"workload": args.workload, "window_s": trace.window_s, "busy_s": trace.busy_s,
                      "busy_s_by_hand": busy_hand, "idle_pct": 100 * (1 - trace.busy_s / trace.window_s),
                      "idle_pct_by_hand": 100 * (1 - busy_hand / trace.window_s),
                      "summed_kernel_s": trace.kernel_seconds(lambda n: True), "device_ops": len(trace.ops)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
