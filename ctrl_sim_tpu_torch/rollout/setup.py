"""The full-width streaming rollout set-up that ``chip_smoke.py`` drives and
``profile_rollout`` profiles: the default model with random weights from a
seeded generator, bf16 compute and cross-attention scores, 256 synthetic
scenes of 12 agents packed into 16 slots (bench.py's chunk and scene
recipe), contacts on, on the card."""

from __future__ import annotations

import torch

LANES, AGENTS, ARENA, LANE_ROADS, SLOTS = 256, 12, 300.0, 4, 16  # bench.py's chunk and scene recipe
CASES = {  # name: overrides of the default config
    "bf16": {},
    "int8": {"model.kv_cache_dtype": "int8"},
    "contacts-off": {"sim.resolve_contacts": False},
}


def full_width_rollout(seed: int = 0):
    """Returns (cfgs, models, scenario, controlled, tilt): a config and a
    model for each of ``CASES``, all models with the same weights."""
    from ctrl_sim_tpu_torch.config import load_config
    from ctrl_sim_tpu_torch.data import stack_scenarios, synthetic_scenario, to_torch
    from ctrl_sim_tpu_torch.data.transforms import get_tilt_logits
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.params import init_params

    base = {"model.cross_score_dtype": "bfloat16", "eval.agent_slots": SLOTS}
    cfgs = {name: load_config({**base, **extra}) for name, extra in CASES.items()}
    cfg = cfgs["bf16"]
    scenes = stack_scenarios(
        [synthetic_scenario(cfg, seed=s, num_agents=AGENTS, arena_half=ARENA, num_lanes=LANE_ROADS)
         for s in range(LANES)], cfg)
    sc = to_torch(scenes, "cuda")
    model = CtRLSim(cfg)
    init_params(model, torch.Generator().manual_seed(seed))
    model_q8 = CtRLSim(cfgs["int8"])
    model_q8.load_state_dict(model.state_dict())  # the same weights
    models = {"bf16": model, "int8": model_q8, "contacts-off": model}
    tilt = get_tilt_logits(0.0, 0.0, 0.0, cfg.waymo, device="cuda")
    return cfgs, models, sc, sc.moving & sc.agent_valid, tilt
