"""Readings that a cell's correctness limits are set from, on the card.

    python3 -m benchmark.calibrate --workload NAME --seeds S1 S2 ... [--control-seeds C1 C2 ...]
                                   [--seconds 1] [--fault NAME] [--out PATH]

For each seed, in one process: the cell's set-up, a short window at the
cell's own sizes, then the check as a run makes it, whose numbers are the
port's readings (the lower readings of the limits). For each control seed
besides, the control: the reference computed with every dense layer's
operands rounded to float8 e4m3 (the precision below the configuration's
bfloat16), put in the port's place and judged by the same comparison (the
upper readings). ``--fault`` plants a fault in the port first (``plant``),
for the faults' readings. Prints one JSON line a seed; ``--out`` appends
them to a file. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from benchmark import harness
from benchmark.reference import check_stream, check_train, weights
from benchmark.trace import Spans


def _control_train(run) -> dict:
    args = (run.config, run.traffic, run.seed, run.scenes, run.device, run.traffic["checked_steps"])
    no_limits = {p + n: None for p in ("", "window_") for n in ("loss_gap", "grad_gap", "change_gap")}
    first = check_train.reference_steps(*args, quantize=True, extra=run.extra)
    window = check_train.reference_steps(*args, quantize=True, extra=run.extra, start=run.window_start)
    return {**check_train.compare(first, run.reference, no_limits),
            **check_train.compare(window, run.window_reference, no_limits, prefix="window_")}


def _control_stream(run) -> dict:
    args = (run.config, run.traffic, run.seed, run.scenes, run.lanes,
            weights.derive(run.seed, "chunks", run.judged), run.judged_out, run.device)
    _, control = check_stream.teacher_forced(*args, quantize=True, extra=run.extra)
    _, ref = check_stream.teacher_forced(*args, candidates=control.own, extra=run.extra)
    out = {"action_gap": ref.gaps["candidate_action_gap"]}
    if run.cfg.policy.predict_rtgs:
        out["rtg_gap"] = ref.gaps["candidate_rtg_gap"]
    return {name: {"value": v, "limit": None} for name, v in out.items()}


def plant(fault: str) -> None:
    """Breaks the port's timed path underneath the runs that follow, for a
    fault's readings: ``half_batch`` (each train step takes half of its
    batch, the mean over the rest), ``env_unchanged`` (each env step returns
    the state it was given)."""
    if fault == "half_batch":
        from ctrl_sim_tpu_torch.training import trainer

        real = trainer.Trainer.make_train_step

        def make_train_step(self):
            step = real(self)
            return lambda state, batch, gen, draws=None: step(
                state, {k: v[: len(v) // 2] for k, v in batch.items()}, gen, draws)

        trainer.Trainer.make_train_step = make_train_step
    elif fault == "env_unchanged":
        from ctrl_sim_tpu_torch.env.env import WaymoEnv

        WaymoEnv.step = lambda self, scenario, state, *args, **kwargs: state
    else:
        raise ValueError(f"unknown fault {fault!r}")


def calibrate(workload: str, seed: int, control: bool, seconds: float, device: str = "cuda",
              config: dict | None = None, traffic: dict | None = None, extra: dict | None = None) -> dict:
    bench = harness.manifest()
    cell = harness.cell(bench, workload)
    config = config or harness.config_file(bench, cell["config"])
    traffic = traffic or harness.traffic_file(cell["traffic"])
    limits = harness.limits_file(workload)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    start = time.perf_counter()
    run = driver.Run(config, traffic, seed, device=device, extra=extra)
    window = run.measure(seconds, Spans())
    run.release()
    row = {"workload": workload, "seed": seed, "attempted": window["attempted"],
           "numbers": {k: v["value"] for k, v in run.check(limits).items()}}
    if hasattr(run, "judged_out"):
        row["judged_chunk"] = run.judged
    else:
        row["leaves_left_out"] = [check_train.left_out(run.reference), check_train.left_out(run.window_reference)]
    if control:
        ctl = (_control_train if traffic["kind"] == "train" else _control_stream)(run)
        row["control"] = {k: v["value"] for k, v in ctl.items()}
    row["seconds"] = time.perf_counter() - start
    return row


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--fault", help="plant this fault in the port first (see plant)")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the calibration runs on the card", file=sys.stderr)
        return 2
    if args.fault:
        plant(args.fault)
    for seed in dict.fromkeys([*args.seeds, *args.control_seeds]):  # each seed once, in order
        row = {**calibrate(args.workload, seed, seed in args.control_seeds, args.seconds), "fault": args.fault}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
