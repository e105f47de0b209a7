"""The manifest's rules, the result line and the import check."""

from __future__ import annotations

import json
import re
import shlex
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = harness.manifest()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WHY = re.compile(r"^[^\t\n]{1,200}$")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == TOP
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch") for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for entry in BENCH[section]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")


def test_configs_files_and_reduced():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and WHY.match(c["why"]) and WHY.match(c["source"])
        data = harness.load_json(harness.ROOT / c["file"])
        assert all(NAME.match(k) and k in data for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])


def test_workloads_reference_files():
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert WHY.match(w["why"])
        harness.config_file(BENCH, w["config"])
        traffic = harness.traffic_file(w["traffic"])
        assert (harness.HERE / "drivers" / f"{traffic['kind']}.py").exists()
        assert harness.limits_file(w["name"])
        used.add(w["config"])
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(BENCH, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(BENCH, "per_layer", w["name"])


def test_per_layer_moves_a_metric_of_each_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert WHY.match(m["layer"]) and m["moves"] in e2e
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert any(x["name"] == m["moves"] for x in harness.metrics_of(BENCH, "end_to_end", cell)), (m, cell)


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_runs_the_harness():
    assert shlex.join(BENCH["command"]) == "python3 -m benchmark.run"


def test_result_line_puts_checks_last():
    line = harness.result_line(True, 3, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                               {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 7},
                               {"loss_gap": {"value": 0.1, "limit": 0.2}}, {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert out["checks"]["loss_gap"] == {"value": 0.1, "limit": 0.2}


@pytest.mark.parametrize("modules, found", [
    ({"ctrl_sim_tpu_torch", "ctrl_sim_tpu_torch.ops.attention", "torch"}, []),
    ({"ctrl_sim_tpu", "numpy"}, ["ctrl_sim_tpu"]),
    ({"ctrl_sim_tpu.ops.flash_attention"}, ["ctrl_sim_tpu.ops.flash_attention"]),
    ({"jax.numpy", "jaxtyping", "flax"}, ["flax", "jax.numpy"]),
    ({"jaxlib.xla_client", "benchmark.reference.sim"}, ["jaxlib.xla_client"]),
])
def test_import_check_compares_whole_top_level_names(modules, found):
    assert harness.forbidden_loaded(modules) == found


def _loaded_after(imports: str) -> list[str]:
    code = f"import sys; {imports}; print(' '.join(sorted(m.split('.', 1)[0] for m in sys.modules)))"
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_harness_loads_nothing_of_jax():
    top = _loaded_after("import benchmark.run, benchmark.calibrate, benchmark.drivers.train, "
                        "benchmark.drivers.stream, benchmark.reference.check_train, "
                        "benchmark.reference.check_stream; import ctrl_sim_tpu_torch.rollout.streaming, "
                        "ctrl_sim_tpu_torch.training")
    assert not set(top) & set(harness.FORBIDDEN_MODULES)


def test_reference_imports_nothing_of_the_port():
    top = _loaded_after("import benchmark.reference.check_train, benchmark.reference.check_stream, "
                        "benchmark.reference.sim.rollout.streaming, benchmark.reference.sim.data.store")
    assert "ctrl_sim_tpu_torch" not in top and not set(top) & set(harness.FORBIDDEN_MODULES)


@pytest.mark.parametrize("alone", [False, True])
def test_no_result_without_a_card_or_without_the_port(tmp_path, alone):
    """Without a card the run exits 2 and prints no result; in a directory
    that holds only ``BENCHMARK.json`` and the benchmark's files it prints
    none either."""
    cwd = harness.ROOT
    if alone:
        import shutil

        shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
        shutil.copytree(harness.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
        cwd = tmp_path
    out = subprocess.run([sys.executable, *BENCH["command"][1:], "--workload", "train.ctrl_sim", "--seed",
                          str(2**32 + 5), "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
