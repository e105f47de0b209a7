"""One run of one cell of the benchmark of ``ctrl_sim_tpu_torch``.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks for.
Set-up (counted as ``setup_s``, from the process's start to the first timed
step) builds the cell's inputs and weights from ``--seed`` and warms up
every shape; the window measures for ``--seconds``; then the port's state is
freed and the plain reference judges what the window produced. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics, read from ``torch.profiler`` over the whole window),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit; the same numbers close standard error.
Exits 2 without a result where the cards are missing, 3 where a module of
JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
# kernel build and compile caches at fixed paths inside the checkout
for _var, _dir in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_ROOT / ".bench_cache" / _dir)
os.environ.setdefault("USE_FLAX", "0")

import argparse  # noqa: E402
import importlib  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.trace import DeviceTrace, Spans  # noqa: E402


class Context:
    """What a per-layer metric reader sees: the cell, its configuration and
    traffic files, the configuration built from them (``cfg``, by the
    benchmark's own copy of the port's ``config``), the device trace and
    host spans of the window and the work it completed (``counts``)."""

    def __init__(self, cell, config, traffic, trace, spans, counts, extra=None):
        from benchmark.reference.sim import config as ref_config

        self.cell, self.config, self.traffic = cell, config, traffic
        self.cfg = harness.build_config(ref_config, config, traffic, extra)
        self.sizes = harness.flat_sizes(config["sizes"])
        self.trace, self.spans, self.counts = trace, spans, counts


def execute(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
            config: dict | None = None, traffic: dict | None = None, extra: dict | None = None) -> dict:
    """One run of ``cell`` after the look for its cards: set-up, window,
    check. Returns the result line's fields. ``config``, ``traffic`` and
    ``extra`` (dotted overrides) stand in for the cell's own in tests."""
    import torch

    config = config or harness.config_file(bench, cell["config"])
    traffic = traffic or harness.traffic_file(cell["traffic"])
    limits = harness.limits_file(cell["name"])
    on_card = device == "cuda"
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    run = driver.Run(config, traffic, seed, device=device, extra=extra)
    harness.sync(device)
    setup_s = harness.process_age_s()

    spans = Spans()
    device_trace = DeviceTrace() if trace else None
    window = run.measure(seconds, spans, device_trace)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    info = {"platform": "gpu" if on_card else "cpu", "count": cell["chips"], "memory_peak_bytes": peak,
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu"}
    breakdown = None
    if trace:
        info.update(busy_s=device_trace.busy_s, window_s=device_trace.window_s)
        ctx = Context(cell, config, traffic, device_trace, spans, window["counts"], extra)
        metrics = {}
        for m in harness.metrics_of(bench, "per_layer", cell["name"]):
            value = harness.load_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = device_trace.breakdown(spans)
    else:
        values = {**window["metrics"], "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in harness.metrics_of(bench, "end_to_end", cell["name"])}
    run.release()
    checks = run.check(limits)
    correct = window["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": window["attempted"], "failed": window["failed"], "metrics": metrics,
            "device": info, "checks": checks, "breakdown": breakdown}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = harness.manifest()
    cell = harness.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = execute(bench, cell, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"modules of JAX or of the JAX package were loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(harness.result_line(out["correct"], out["attempted"], out["failed"], out["metrics"], out["device"],
                              out["checks"], out["breakdown"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
