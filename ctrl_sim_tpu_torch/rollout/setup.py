"""The full-width rollout set-ups that ``chip_smoke.py`` drives and
``profile_rollout`` profiles, on the card. The streaming rollout: each
family's model with random weights from a seeded generator, bf16 compute
and cross-attention scores, 256 synthetic scenes of 12 agents packed into
16 slots (bench.py's chunk and scene recipe), contacts on. The exact
rollout (``exact_eval_setup``): the default model as ``eval_sim`` builds
it, seeded, and one evaluation chunk of 32 scenes."""

from __future__ import annotations

import torch

LANES, AGENTS, ARENA, LANE_ROADS, SLOTS = 256, 12, 300.0, 4, 16  # bench.py's chunk and scene recipe
EVAL_LANES = 32  # one chunk of eval_sim's default lane batch
CASES = {  # name: (preset, overrides of it); bench.py's configurations of the default family
    "bf16": ("ctrl_sim", {}),
    "int8": ("ctrl_sim", {"model.kv_cache_dtype": "int8"}),
    "contacts-off": ("ctrl_sim", {"sim.resolve_contacts": False}),
}
FAMILY_CASES = {  # the other families, and the default family's sequential decode
    "dt": ("dt", {}),
    "il": ("il", {}),
    "trajeglish": ("trajeglish", {}),
    "dt-int8": ("dt", {"model.kv_cache_dtype": "int8"}),
    "3-pass": ("ctrl_sim", {"eval.streaming_passes": 3}),
}


def _config(name: str, **extra):
    """(preset name, config) of the case ``name`` of ``CASES`` or
    ``FAMILY_CASES``, with ``extra`` overrides on top."""
    from ctrl_sim_tpu_torch.config import _set_dotted, preset

    family, over = {**CASES, **FAMILY_CASES}[name]
    cfg = preset(family)
    for key, value in {"model.cross_score_dtype": "bfloat16", "eval.agent_slots": SLOTS, **over, **extra}.items():
        cfg = _set_dotted(cfg, key, value)
    return family, cfg


def _scenario(cfg, lanes: int, device):
    from ctrl_sim_tpu_torch.data import stack_scenarios, synthetic_scenario, to_torch

    scenes = stack_scenarios(
        [synthetic_scenario(cfg, seed=s, num_agents=AGENTS, arena_half=ARENA, num_lanes=LANE_ROADS)
         for s in range(lanes)], cfg)
    return to_torch(scenes, device)


def full_width_rollout(seed: int = 0):
    """Returns (cfgs, models, scenario, controlled, tilt): a config and a
    model for each case of ``CASES`` and ``FAMILY_CASES``; the models of
    one preset share their weights."""
    from ctrl_sim_tpu_torch.data.transforms import get_tilt_logits
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.params import init_params

    cfgs, models, weights = {}, {}, {}
    for name in {**CASES, **FAMILY_CASES}:
        family, cfg = _config(name)
        model = CtRLSim(cfg)
        if family not in weights:
            init_params(model, torch.Generator().manual_seed(seed))
            weights[family] = model.state_dict()
        model.load_state_dict(weights[family])
        cfgs[name], models[name] = cfg, model
    sc = _scenario(cfg, LANES, "cuda")
    tilt = get_tilt_logits(0.0, 0.0, 0.0, cfg.waymo, device="cuda")
    return cfgs, models, sc, sc.moving & sc.agent_valid, tilt


def recorded_masks(cfg, model, scenario, controlled) -> list:
    """``masks[t][p]``: the [Q, N] mask that ``run_streaming`` gives the
    first decoder layer in decode pass p of step t, the kernels' mask
    input on that path. For the run, every layer of ``model`` is replaced
    by a stand-in that keeps the mask and passes the tokens through, so no
    kernel runs and the cache stays empty (the masks follow from the
    ring's slot labels alone)."""
    from ctrl_sim_tpu_torch.rollout.streaming import run_streaming

    passes = []

    def record(x, k_buf, v_buf, writes, mask, *args, **kwargs):
        passes.append(mask)
        return x

    def through(x, *args, **kwargs):
        return x

    for i, layer in enumerate(model.decoder.layers):
        layer.decode_step = record if i == 0 else through
    try:
        gen = torch.Generator(device=scenario.traj_position.device).manual_seed(0)
        run_streaming(cfg, model, scenario, controlled, gen)
    finally:
        for layer in model.decoder.layers:
            del layer.decode_step
    steps = cfg.sim.steps
    if len(passes) % steps:
        raise AssertionError(f"{len(passes)} decode passes over {steps} steps")
    per_step = len(passes) // steps
    return [passes[t * per_step:(t + 1) * per_step] for t in range(steps)]


def decode_masks(case: str, steps: int, device) -> list:
    """``recorded_masks`` of steps 0 .. steps - 1 of the case ``case`` at
    full width (16 slots, window 32), over two scenes and one decoder
    layer."""
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.params import init_params

    _, cfg = _config(case, **{"sim.steps": steps, "model.num_decoder_layers": 1})
    model = CtRLSim(cfg, device)
    init_params(model, torch.Generator().manual_seed(0))
    sc = _scenario(cfg, 2, device)
    return recorded_masks(cfg, model, sc, sc.moving & sc.agent_valid)


def eval_scenes(cfg, lanes: int = EVAL_LANES, agents: int = AGENTS, conflict_pairs: int = 0) -> list:
    """The synthetic numpy scenes that ``python -m ctrl_sim_tpu_torch.eval_sim
    --synthetic {lanes} --synthetic_agents {agents} --synthetic_conflict
    {conflict_pairs}`` evaluates (``synthetic_scenario``'s arena and lanes).
    At 12 agents their vehicles fall into 3-6 focal groups a scene."""
    from ctrl_sim_tpu_torch.data import synthetic_scenario

    return [synthetic_scenario(cfg, seed=s, num_agents=agents, conflict_pairs=conflict_pairs)
            for s in range(lanes)]


def exact_eval_setup(seed: int = 0):
    """(cfg, model, scenes) of the exact-mode evaluation at full width: the
    default family as ``eval_sim`` builds it (hidden 256, 8 heads, FF 1024,
    2 + 4 layers, bf16 compute, contacts on, ``eval.rollout_mode="exact"``),
    seeded weights in eval mode, and ``eval_scenes``."""
    from ctrl_sim_tpu_torch.config import preset
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.params import init_params

    cfg = preset("ctrl_sim")
    model = CtRLSim(cfg)
    init_params(model, torch.Generator().manual_seed(seed))
    model.eval()
    return cfg, model, eval_scenes(cfg)
