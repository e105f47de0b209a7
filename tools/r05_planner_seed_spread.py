"""Spread of the r05 planner-vs-adversary metrics over eval seeds, for the
JAX package and for the PyTorch port, on the CPU.

``artifacts/eval_r05_planner.json`` is one run (eval seed 0) of the JAX
package. This prints, for eval seeds 0 .. N-1 and adversary veh-veh tilts
-10 and -50, ``ego_cr_w_adv`` and ``adv_coll_speed`` of each package on the
artifact's scenes (64 held-out scenes from seed 1000 with two crossing
pairs, streaming, the relaxed pair thresholds), and writes the JAX
package's per-seed readings to ``artifacts/torch/eval_r05_planner_jax_seeds.json``:
``chip_smoke.py``'s ``planner-adversary-trained`` phase holds the port's
mean over the same eval seeds to their mean. Needs JAX (the orbax
checkpoint) and the converted checkpoint of the port; about 8 minutes on
8 CPU cores.

    JAX_PLATFORMS=cpu python tools/r05_planner_seed_spread.py
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PLANNER = {
    "eval.rollout_mode": "streaming", "eval.interesting_traj_len_threshold": 20,
    "eval.interesting_timestep_diff_threshold": 5, "eval.interesting_goal_dist_threshold": 1000.0,
}
TILTS = (-10.0, -50.0)
LEGS = ("reference_tilts", "strong_adversary")  # the artifact's names of tilts -10 and -50
SEEDS = range(8)
OUT = os.path.join(REPO, "artifacts", "torch", "eval_r05_planner_jax_seeds.json")
KEYS = ("ego_cr_w_adv", "adv_coll_speed")


def _convert_tool():
    spec = importlib.util.spec_from_file_location("convert", os.path.join(REPO, "tools", "convert_checkpoints_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_runs(seeds):
    from ctrl_sim_tpu.config import TiltConfig, _set_dotted
    from ctrl_sim_tpu.data.synthetic import synthetic_scenario
    from ctrl_sim_tpu.evals.planner_adversary import PlannerAdversaryEvaluator
    from ctrl_sim_tpu.models.ctrl_sim import CtRLSim

    directory, step = _convert_tool().CHECKPOINTS["r05_s0"]
    cfg, state = _convert_tool().restore_jax(directory, step)
    for key, value in PLANNER.items():
        cfg = _set_dotted(cfg, key, value)
    scenes = [synthetic_scenario(cfg, seed=1000 + s, num_agents=8, conflict_pairs=2) for s in range(64)]
    model = CtRLSim(cfg)
    for seed in seeds:
        c = _set_dotted(cfg, "eval.seed", seed)
        yield seed, [PlannerAdversaryEvaluator(c, model, state.params, adversary_tilt=TiltConfig(veh_veh_tilt=t),
                                               lane_batch=32).evaluate(scenes) for t in TILTS]


def port_runs(seeds):
    from ctrl_sim_tpu_torch.config import TiltConfig, _set_dotted
    from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario
    from ctrl_sim_tpu_torch.evals.planner_adversary import PlannerAdversaryEvaluator
    from ctrl_sim_tpu_torch.training.checkpoint import checkpoint_config, restore_model

    directory = os.path.join(REPO, "artifacts", "torch", "r05_s0")
    cfg = checkpoint_config(directory, PLANNER)
    model, _ = restore_model(cfg, directory, "cpu")
    scenes = [synthetic_scenario(cfg, seed=1000 + s, num_agents=8, conflict_pairs=2) for s in range(64)]
    for seed in seeds:
        c = _set_dotted(cfg, "eval.seed", seed)
        yield seed, [PlannerAdversaryEvaluator(c, model, adversary_tilt=TiltConfig(veh_veh_tilt=t), lane_batch=32,
                                               device="cpu").evaluate(scenes) for t in TILTS]


def main() -> None:
    for name, runs in (("jax", jax_runs), ("port", port_runs)):
        values = {(t, k): [] for t in TILTS for k in KEYS}
        for seed, metrics in runs(SEEDS):
            for t, m in zip(TILTS, metrics):
                for k in KEYS:
                    values[t, k].append(float(m[k]))
            print(f"{name} seed {seed}: " + "; ".join(
                f"tilt {t:g} " + ", ".join(f"{k} {m[k]:.4f}" for k in KEYS) for t, m in zip(TILTS, metrics)),
                flush=True)
        for (t, k), xs in values.items():
            print(f"{name} tilt {t:g} {k}: mean {statistics.fmean(xs):.4f}, sd {statistics.stdev(xs):.4f}, "
                  f"range {min(xs):.4f}-{max(xs):.4f} over {len(xs)} seeds", flush=True)
        if name == "jax":
            record = {"meta": {"package": "ctrl_sim_tpu", "platform": "cpu", "ckpt": "artifacts/r05/ckpt_s0",
                               "scenes": 64, "conflict_pairs": 2, "scene_seed0": 1000, **PLANNER},
                      "eval_seeds": list(SEEDS),
                      **{leg: {k: values[t, k] for k in KEYS} for leg, t in zip(LEGS, TILTS)}}
            with open(OUT, "w") as f:
                json.dump(record, f, indent=2)
                f.write("\n")
            print(f"wrote {os.path.relpath(OUT, REPO)}", flush=True)


if __name__ == "__main__":
    main()
