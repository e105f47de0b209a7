#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA card, nvcc and the checkout; it imports nothing of JAX. Phases,
each printing one line with its own seconds; any failure raises, so the exit
code is 0 only when every phase passed:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA kernel of the port, compiled by nvcc from the sources
   in the checkout (one nvcc per source, all started together);
3. kernel K1 (decode attention) against its plain PyTorch version on the
   card: the rollout's shapes (256 lanes, Q = 32 and 16 queries, N = 1536
   keys, H = 256 = 8 heads x 32) in bf16 and f32, a narrow case (H = 64 =
   4 x 16, Q = 12) and a mask with fully masked rows; tolerance 2e-2
   absolute in bf16, 1e-4 in f32. Times (CUDA events, median of 30
   launches after warm-up) of the kernel, the plain version and one
   library call, F.scaled_dot_product_attention, kept as a yardstick only;
4. small-input agreement: the streaming rollout at a toy width on the card,
   replaying the draws of the same rollout on the CPU, agrees with it;
5. the main path at full width: random weights from a seeded generator
   (hidden 256, 8 heads, FF 1024, 2 + 4 layers, bf16 compute, bf16
   cross-attention scores), 256 synthetic scenes of 12 agents packed into
   16 slots, ``run_streaming`` for 90 steps with contacts off; every output
   finite, and K1 launched exactly 2 passes x 4 layers x 90 steps = 720
   times.

Then one line ``{"kernels": [...]}`` and, last, the device line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
LANES = 256  # one bench chunk of scenes
AGENTS, LANE_ROADS, ARENA = 12, 4, 300.0  # bench.py's scene recipe
SLOTS = 16
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet, dense rates below too)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; fp32 outside them
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _phase(name: str, t0: float, detail: str = "") -> None:
    print(f"[{name}] {time.perf_counter() - t0:.2f}s {detail}".rstrip(), flush=True)


def _median_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _attention_case(B, Q, N, H, heads, dtype, mask, gen):
    """Kernel vs plain version on one input; returns the measured row."""
    import torch
    import torch.nn.functional as F

    from ctrl_sim_tpu_torch.ops import attention

    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt) for shape in
               ((B, Q, H), (B, N, H), (B, N, H)))
    got = attention.cached_decode_attention(q, k, v, mask, heads)
    want = attention.cached_decode_attention_reference(q, k, v, mask, heads)
    torch.cuda.synchronize()
    rows = (mask != 0).any(dim=1)  # rows with a visible key; the others are unused
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"K1 gave non-finite values at B={B} Q={Q} N={N} H={H} {dtype}")
    err = (got.float() - want.float())[:, rows].abs().max().item()
    if err > TOL[dtype]:
        raise AssertionError(f"K1 disagrees with its plain version: {err} > {TOL[dtype]}")

    d = H // heads
    q4, k4, v4 = (x.view(x.shape[0], x.shape[1], heads, d).transpose(1, 2) for x in (q, k, v))
    bool_mask = mask != 0
    es = q.element_size()
    nbytes = (2 * B * Q * H + 2 * B * N * H) * es + Q * N
    ops = 4 * B * Q * N * H
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {
        "shape": f"B={B} Q={Q} N={N} H={H}/{heads} {dtype}",
        "max_abs_err": err,
        "ms": _median_ms(lambda: attention.cached_decode_attention(q, k, v, mask, heads)),
        "plain_ms": _median_ms(lambda: attention.cached_decode_attention_reference(q, k, v, mask, heads)),
        "library_ms": _median_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bool_mask)),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


class _RecordingSampler:
    """The policy's draws, with the logits they were drawn from."""

    def __init__(self, inner):
        self.inner, self.rtg, self.act, self.logits = inner, [], [], []

    def rtgs(self, t, logits, tilt):
        self.rtg.append(self.inner.rtgs(t, logits, tilt))
        return self.rtg[-1]

    def actions(self, t, logits):
        self.logits.append(logits.float().cpu())
        self.act.append(self.inner.actions(t, logits))
        return self.act[-1]


class _ReplaySampler:
    def __init__(self, rtg, act, device):
        self.rtg = [x.to(device) for x in rtg]
        self.act = [x.to(device) for x in act]
        self.logits = []

    def rtgs(self, t, logits, tilt):
        return self.rtg[t]

    def actions(self, t, logits):
        self.logits.append(logits.float().cpu())
        return self.act[t]


def _small_agreement() -> str:
    """The toy-width rollout on the card against the same rollout on the CPU
    (plain kernels), with the CPU run's draws replayed on the card."""
    import torch

    from ctrl_sim_tpu_torch.config import load_config
    from ctrl_sim_tpu_torch.data import stack_scenarios, synthetic_scenario, to_torch
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.params import init_params
    from ctrl_sim_tpu_torch.rollout.streaming import PolicySampler, run_streaming

    cfg = load_config({
        "model.hidden_dim": 64, "model.num_heads": 4, "model.dim_feedforward": 128,
        "model.num_transformer_encoder_layers": 1, "model.num_decoder_layers": 2,
        "model.compute_dtype": "float32", "waymo.max_num_agents": 12, "sim.max_agents": 12,
        "eval.agent_slots": 8, "waymo.train_context_length": 8, "sim.steps": 16,
        "sim.history_steps": 4, "sim.resolve_contacts": False,
    })
    scenes = stack_scenarios(
        [synthetic_scenario(cfg, seed=SEED + s, num_agents=8, arena_half=60.0, num_lanes=2)
         for s in range(4)], cfg)
    runs = {}
    for device in ("cpu", "cuda"):
        model = CtRLSim(cfg, device=device)
        init_params(model, torch.Generator().manual_seed(SEED))
        sc = to_torch(scenes, device)
        if device == "cpu":
            sampler = _RecordingSampler(PolicySampler(cfg, torch.Generator().manual_seed(SEED)))
        else:
            sampler = _ReplaySampler(runs["cpu"][1].rtg, runs["cpu"][1].act, device)
        out = run_streaming(cfg, model, sc, sc.moving & sc.agent_valid, None, sampler=sampler)
        runs[device] = (out, sampler)
    (cpu, cs), (gpu, gs) = runs["cpu"], runs["cuda"]
    logit_err = max((a - b).abs().max().item() for a, b in zip(cs.logits, gs.logits))
    pos_err = (cpu.position - gpu.position.cpu()).abs().max().item()
    rew_err = (cpu.reward8 - gpu.reward8.cpu()).abs().max().item()
    if logit_err > 1e-3 or pos_err > 1e-3 or rew_err > 1e-3:
        raise AssertionError(
            f"card and CPU rollouts disagree: logits {logit_err}, positions {pos_err}, reward8 {rew_err}")
    return f"max |d action logits| {logit_err:.3g}, |d position| {pos_err:.3g}, |d reward8| {rew_err:.3g}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ctrl_sim_tpu_torch.config import load_config
        from ctrl_sim_tpu_torch.data import stack_scenarios, synthetic_scenario, to_torch
        from ctrl_sim_tpu_torch.data.transforms import get_tilt_logits
        from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
        from ctrl_sim_tpu_torch.ops import attention, build
        from ctrl_sim_tpu_torch.ops.masks import stream_step_masks
        from ctrl_sim_tpu_torch.params import init_params
        from ctrl_sim_tpu_torch.rollout.streaming import run_streaming
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _phase("device", t0, kind)
    print(smi, flush=True)

    t0 = time.perf_counter()
    reports = build.build()
    for source, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {source}: {line.strip()}")
    build_s = time.perf_counter() - t0
    _phase("build", t0, f"{len(reports)} of {len(build.SOURCES)} sources compiled")

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    window, K = 32, 3
    mask1, mask2 = stream_step_masks(90, window, SLOTS, K, 0, device="cuda")
    t_mid = 45  # a full window, past the ring's first wrap
    cases = {}
    for dtype in ("bfloat16", "float32"):
        for name, mask in (("pass1", mask1[t_mid]), ("pass2", mask2[t_mid])):
            Q, N = mask.shape
            cases[f"{name} {dtype}"] = _attention_case(LANES, Q, N, 256, 8, dtype, mask, gen)
        narrow = (torch.rand((12, 384), generator=gen, device="cuda") > 0.4).to(torch.int8)
        narrow[:, 0] = 1
        cases[f"narrow {dtype}"] = _attention_case(64, 12, 384, 64, 4, dtype, narrow, gen)
        dead = mask1[0].clone()  # the t = -1 action rows see no key at t = 0
        if dead.any(dim=1).all():
            raise AssertionError("expected fully masked rows in the t = 0 mask")
        cases[f"masked rows {dtype}"] = _attention_case(LANES, *dead.shape, 256, 8, dtype, dead, gen)
    for name, row in cases.items():
        print(f"  K1 {name}: {row['shape']} err {row['max_abs_err']:.3g} "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    _phase("k1-vs-plain", t0, f"{len(cases)} cases within 2e-2 (bf16) / 1e-4 (f32)")

    t0 = time.perf_counter()
    detail = _small_agreement()
    _phase("small-agreement", t0, detail)

    t0 = time.perf_counter()
    cfg = load_config({
        "model.cross_score_dtype": "bfloat16",
        "sim.resolve_contacts": False,
        "eval.agent_slots": SLOTS,
    })
    scenes = stack_scenarios(
        [synthetic_scenario(cfg, seed=s, num_agents=AGENTS, arena_half=ARENA, num_lanes=LANE_ROADS)
         for s in range(LANES)], cfg)
    sc = to_torch(scenes, "cuda")
    model = CtRLSim(cfg)
    init_params(model, torch.Generator().manual_seed(SEED))
    controlled = sc.moving & sc.agent_valid
    tilt = get_tilt_logits(0.0, 0.0, 0.0, cfg.waymo, device="cuda")
    _phase("setup", t0, f"{LANES} scenes, {sum(p.numel() for p in model.parameters())} params")

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    attention.cached_decode_attention.launches = 0
    start = time.perf_counter()
    out = run_streaming(cfg, model, sc, controlled, torch.Generator(device="cuda").manual_seed(SEED), tilt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = attention.cached_decode_attention.launches
    steps = cfg.sim.steps
    expected = 2 * cfg.model.num_decoder_layers * steps
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times on the main path, expected {expected}")
    for name, x in out._asdict().items():
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"non-finite rollout output {name}")
    if out.position.shape != (steps + 1, LANES, scenes.traj_position.shape[1], 2):
        raise AssertionError(f"unexpected position shape {tuple(out.position.shape)}")
    _phase("rollout", t0, f"{LANES} lanes x {steps} steps in {elapsed:.3f}s = "
           f"{LANES * steps / elapsed:.1f} env-steps/s on this card (one cold run, not a benchmark); "
           f"K1 launches {launches}")

    main_rows = [cases["pass1 bfloat16"], cases["pass2 bfloat16"]]  # the path's two shapes, 360 launches each
    mean = lambda key: statistics.fmean(r[key] for r in main_rows)  # noqa: E731
    print(json.dumps({"kernels": [{
        "name": "cached_decode_attention",
        "route": "cuda",
        "source": "ctrl_sim_tpu_torch/csrc/decode_attention.cu",
        "replaces": "ctrl_sim_tpu/ops/attention.py:142",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "ms": mean("ms"),
        "kernel_ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": main_rows[0]["bound_by"],
        "library_ms": mean("library_ms"),
        "build_s": build_s,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
