"""What every cell of the benchmark shares: the manifest (``BENCHMARK.json``)
and the files it names, configurations built from them, the scenes drawn
from a run's seed, the import check and the result line.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the mix's ``kind`` picks the module that runs
it (``drivers/<kind>.py``), and each per-layer metric is read by
``metrics/<name>.py``. Adding a cell or a metric adds files and entries and
edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ctrl_sim_tpu")
# the reference computes in float32 what the configuration runs in bfloat16
REFERENCE_PRECISION = {"model.compute_dtype": "float32", "model.kv_cache_dtype": "float32",
                       "model.cross_score_dtype": "float32"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == workload:
            return entry
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    for entry in bench["configs"]:
        if entry["name"] == name:
            return load_json(root / entry["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits_file(workload: str) -> dict:
    return load_json(HERE / "limits" / f"{workload}.json")


def metrics_of(bench: dict, section: str, workload: str) -> list[dict]:
    """The metrics of ``section`` (end_to_end or per_layer) that the cell
    reports: those without a ``workloads`` list, and those that list it."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def build_config(config_module, config: dict, traffic: dict, extra: dict | None = None):
    """The configuration a cell runs: the preset of ``config``, its
    overrides, the traffic's, then ``extra``; ``config_module`` is the
    port's ``config`` or the reference's copy of it."""
    cfg = config_module.preset(config["preset"])
    for key, value in {**config.get("overrides", {}), **traffic.get("overrides", {}), **(extra or {})}.items():
        cfg = config_module._set_dotted(cfg, key, value)
    return cfg


def dotted(cfg, key: str):
    for part in key.split("."):
        cfg = getattr(cfg, part)
    return cfg


def check_sizes(cfg, sizes: dict) -> None:
    """Raises where the configuration built differs from the sizes its file
    states."""
    wrong = {k: (dotted(cfg, k), v) for k, v in sizes.items() if dotted(cfg, k) != v}
    if wrong:
        raise ValueError(f"the configuration differs from its file's sizes (built, stated): {wrong}")


def flat_sizes(sizes: dict) -> dict:
    """The sizes by their last name (``model.hidden_dim`` -> ``hidden_dim``),
    as the yardstick reads them."""
    return {k.rsplit(".", 1)[-1]: v for k, v in sizes.items()}


def scenes(config: dict, traffic: dict, seed: int, extra: dict | None = None) -> list:
    """The cell's synthetic scenes, numpy, drawn from the run's seed: scene i
    from the seed sequence (seed, scenes, i). The generator is the
    benchmark's frozen copy; both sides receive these scenes."""
    from benchmark.reference.sim import config as ref_config
    from benchmark.reference.sim.data.synthetic import synthetic_scenario

    cfg = build_config(ref_config, config, traffic, extra)
    from benchmark.reference.weights import STREAMS

    return [synthetic_scenario(cfg, seed=np.random.SeedSequence([int(seed), STREAMS["scenes"], i]),
                               num_agents=config["agents_per_scene"], arena_half=traffic["arena_half"],
                               num_lanes=traffic["lane_roads"])
            for i in range(traffic["scenes"])]


def to_program(scene):
    """A scene as the port's ``Scenario``: the same fields, the same arrays."""
    from ctrl_sim_tpu_torch.data.scenario import Scenario

    return Scenario(**{f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)})


def load_reader(name: str):
    """The per-layer metric reader ``metrics/<name>.py``: a module with
    ``read(ctx) -> float | None``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of ``FORBIDDEN_MODULES`` as a whole word."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


def p90(values: list[float]) -> float:
    """The 90th percentile, as ``statistics.quantiles(values, n=10)`` cuts it
    (of fewer than two values, the largest)."""
    return statistics.quantiles(values, n=10)[-1] if len(values) > 1 else max(values)


def process_age_s() -> float:
    """Seconds since this process started (its start time in clock ticks
    after boot, against the uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The contract's last line of standard output: ``checks`` comes last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def sync(device) -> None:
    """Waits for the card's queue (nothing to wait for on the CPU)."""
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


class Marks:
    """Points in a window's stream of work: CUDA events on the card, read
    after the window without a synchronize per mark; the host's clock on
    the CPU."""

    def __init__(self, device):
        self.cuda = str(device).startswith("cuda")
        self.items = []

    def mark(self) -> None:
        if self.cuda:
            import torch

            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.items.append(event)
        else:
            self.items.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        pairs = zip(self.items[:-1], self.items[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]
