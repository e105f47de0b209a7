"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
(``--device cpu``) at a few scenes each, on the trained checkpoint
converted for the port: their output rows, parsed as
``tests/test_examples.py`` parses the JAX examples', the restored step,
and finite metrics. On the card ``chip_smoke.py`` runs them at their
default sizes."""

import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script), "--device", "cpu", *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _rows(out: str) -> dict[float, list[float]]:
    """Table rows: four numbers, the first the tilt."""
    rows = {}
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0].lstrip("-").isdigit():
            rows[float(parts[0])] = [float(x) for x in parts[1:]]
    return rows


def test_torch_tilt_control_example():
    out = _run("torch_tilt_control.py", "--scenes", "4")
    assert "restored step 26000 from" in out
    rows = _rows(out)
    assert set(rows) == {-50.0, 0.0, 10.0}, out
    assert all(math.isfinite(x) for row in rows.values() for x in row)
    # the dose response: negative tilt degrades (higher ADE than positive)
    assert rows[-50.0][2] > rows[10.0][2], rows


def test_torch_adversarial_scenarios_example():
    out = _run("torch_adversarial_scenarios.py", "--scenes", "4")
    assert "restored step 26000 from" in out
    assert "adversary tilt" in out
    rows = _rows(out)
    assert set(rows) == {-10.0, -50.0}, out
    assert all(math.isfinite(x) for row in rows.values() for x in row)
    assert all(0.0 <= row[0] <= 1.0 for row in rows.values())


def test_torch_replay_rollout_example():
    out = _run("torch_replay_rollout.py")
    assert "OK" in out
    ade = [float(line.split()[-2]) for line in out.splitlines() if line.startswith("replay ADE vs GT")]
    assert len(ade) == 1 and math.isfinite(ade[0]) and ade[0] < 0.15, out
