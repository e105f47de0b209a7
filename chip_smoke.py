#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA card, nvcc and the checkout; it imports nothing of JAX. Phases,
each printing one line with its own seconds; any failure raises, so the exit
code is 0 only when every phase passed:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA kernel of the port, compiled by nvcc from the sources
   in the checkout (one nvcc per source, all started together), with
   ptxas's registers and spills;
3. kernel K1 (decode attention) against its plain PyTorch version on the
   card: the rollout's shapes (256 lanes, Q = 32 and 16 queries, N = 1536
   keys, H = 256 = 8 heads x 32) in bf16 and f32, a narrow case (H = 64 =
   4 x 16, Q = 12) and a mask with fully masked rows; tolerance 2e-2
   absolute in bf16, 1e-4 in f32. Times (CUDA events, median of 30
   launches after warm-up) of the kernel, the plain version and one
   library call, F.scaled_dot_product_attention, kept as a yardstick only;
4. kernels K3/K4 (training flash attention, forward and backward) against
   the plain version on the card: output, lse, dq, dk and dv at the train
   step's shape (B = 16, T = 32 x 24 x 3 = 2304, H = 256 = 8 x 32, bf16,
   dropout 0.1), then at that T and width with B = 4 in bf16 and f32 with
   dropout 0 and 0.1, a ragged T (29 x 23 x 3 = 2001) and a narrow width
   (H = 64 = 4 x 16); tolerances 2e-2 absolute on outputs and 5e-2 of max
   |grad| on gradients in bf16, 1e-4 and 1e-4 in f32. Times of the kernels,
   the plain version and the library yardstick (SDPA with the boolean
   [T, T] mask, at dropout 0) on the train step's B = 16 inputs;
5. small-input agreement: the streaming rollout at a toy width on the card,
   replaying the draws of the same rollout on the CPU, agrees with it;
6. the rollout at full width: random weights from a seeded generator
   (hidden 256, 8 heads, FF 1024, 2 + 4 layers, bf16 compute, bf16
   cross-attention scores), 256 synthetic scenes of 12 agents packed into
   16 slots, ``run_streaming`` for 90 steps with contacts off; every output
   finite, and K1 launched exactly 2 passes x 4 layers x 90 steps = 720
   times;
7. train-small-agreement: one train step at a toy width (f32, dropout and
   goal dropout 0) from the same params and batch on the card (K3/K4) and
   on the CPU (plain version): losses, gradients and updated params within
   1e-4;
8. train at full width: the default model with dropout 0.1, 64 synthetic
   scenes of 12 agents replayed through physics (contacts off) into a
   ``ScenarioStore``, 10 steps of ``Trainer.make_train_step`` at global
   batch 64 as 16 x 4 accumulation; every loss and the gradient norm
   finite, and exactly 4 layers x 4 microbatches = 16 K3 and 16 K4
   launches per step.

Then one line ``{"kernels": [...]}`` and, last, the device line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

SEED = 0
LANES = 256  # one bench chunk of scenes
AGENTS, LANE_ROADS, ARENA = 12, 4, 300.0  # bench.py's scene recipe
SLOTS = 16
TRAIN_STEPS = 10
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet, dense rates below too)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; fp32 outside them
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}  # of max |grad|


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


def _flash_inputs(B, steps, A, K, heads, d, dtype, gen):
    import torch

    T, D = steps * A * K, heads * d
    return [torch.randn((B, T, D), generator=gen, device="cuda").to(dtype) for _ in range(4)]


def _flash_compare(q, k, v, do, spec, heads, dropout_p, seed):
    """K3 and K4 against the plain version (autograd for the gradients) on
    one input; returns the errors, outputs' absolute and gradients'
    relative to max |grad|."""
    import torch

    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    dtype = str(q.dtype).removeprefix("torch.")
    out, lse = fa.flash_mha_fwd(q, k, v, spec, heads, dropout_p, seed)
    grads = fa.flash_mha_bwd(q, k, v, out, do, lse, spec, heads, dropout_p, seed)
    leaves = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    want, want_lse = fa.flash_mha_reference(*leaves, spec, heads, dropout_p, seed)
    want_grads = torch.autograd.grad(want, leaves, do.float())
    torch.cuda.synchronize()
    for name, x in (("out", out), ("lse", lse), *zip(("dq", "dk", "dv"), grads)):
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"K3/K4 gave non-finite {name} at T={q.shape[1]} {dtype}")
    out_err = max((out.float() - want).abs().max().item(), (lse - want_lse).abs().max().item())
    grad_err = max((g.float() - w).abs().max().item() / w.abs().max().item()
                   for g, w in zip(grads, want_grads))
    grad_abs = max((g.float() - w).abs().max().item() for g, w in zip(grads, want_grads))
    B, T, D = q.shape
    if out_err > TOL[dtype] or grad_err > GRAD_TOL[dtype]:
        raise AssertionError(
            f"K3/K4 disagree with the plain version at B={B} T={T} H={D}/{heads} "
            f"{dtype} p={dropout_p}: outputs {out_err} (tol {TOL[dtype]}), gradients "
            f"{grad_err} of max |grad| (tol {GRAD_TOL[dtype]})")
    return {"shape": f"B={B} T={T} H={D}/{heads} {dtype} p={dropout_p}",
            "out_err": out_err, "grad_err": grad_err, "grad_abs_err": grad_abs}


def _flash_case(B, steps, A, K, heads, d, dtype, dropout_p, gen):
    import torch

    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(B, steps, A, K, heads, d, getattr(torch, dtype), gen)
    return _flash_compare(q, k, v, do, fa.MaskSpec(A, K, 0, False, None), heads, dropout_p,
                          torch.tensor([0x5EED], device="cuda"))


def _flash_bounds(B, T, H, heads, spec, dtype):
    """Least times of K3 and K4 on this card for these inputs: the larger
    of the mask's admitted pairs' operations at the peak rate and the bytes
    read once and written once at the memory rate."""
    import torch

    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    idx = torch.arange(T, device="cuda")
    pairs = int(fa.block_mask(idx[:, None], idx[None, :], T, spec).sum().item())
    es = torch.finfo(getattr(torch, dtype)).bits // 8
    tensor, lse = B * T * H * es, B * heads * T * 4
    out = {"pairs": pairs}
    for name, flops, nbytes in (("fwd", 4 * pairs * H * B, 4 * tensor + lse),
                                ("bwd", 10 * pairs * H * B, 8 * tensor + lse)):
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_OPS_PER_S[dtype] * 1e3
        out[name] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations")
    return out


def _flash_main(gen):
    """K3/K4 on one input at the train step's shape (B = 16, T = 2304,
    H = 256 / 8, bf16, dropout 0.1): held against the plain version, then
    timed, and the plain version and the library yardstick (SDPA, boolean
    mask, dropout 0) timed on the same inputs."""
    import torch
    import torch.nn.functional as F

    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    B, steps, A, K, heads, d = 16, 32, 24, 3, 8, 32
    spec = fa.MaskSpec(A, K, 0, False, None)
    seed = torch.tensor([7], device="cuda")
    q, k, v, do = _flash_inputs(B, steps, A, K, heads, d, torch.bfloat16, gen)
    T = q.shape[1]
    res = {"check": _flash_compare(q, k, v, do, spec, heads, 0.1, seed),
           "bound": _flash_bounds(B, T, heads * d, heads, spec, "bfloat16")}
    torch.cuda.empty_cache()
    out, lse = fa.flash_mha_fwd(q, k, v, spec, heads, 0.1, seed)
    res["fwd_ms"] = _median_ms(lambda: fa.flash_mha_fwd(q, k, v, spec, heads, 0.1, seed))
    res["bwd_ms"] = _median_ms(lambda: fa.flash_mha_bwd(q, k, v, out, do, lse, spec, heads, 0.1, seed))

    idx = torch.arange(T, device="cuda")
    mask = fa.block_mask(idx[:, None], idx[None, :], T, spec)
    q4, k4, v4 = (x.view(B, T, heads, d).transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    res["library_fwd_ms"] = _median_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), reps=10, warmup=2)
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    do4 = do.view(B, T, heads, d).transpose(1, 2)
    res["library_bwd_ms"] = _median_ms(
        lambda: torch.autograd.grad(lib_out, (q4, k4, v4), do4, retain_graph=True), reps=10, warmup=2)
    del lib_out, q4, k4, v4
    torch.cuda.empty_cache()

    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        res["plain_fwd_ms"] = _median_ms(
            lambda: fa.flash_mha_reference(q, k, v, spec, heads, 0.1, seed), reps=10, warmup=2)
    ref_out, _ = fa.flash_mha_reference(*leaves, spec, heads, 0.1, seed)
    res["plain_bwd_ms"] = _median_ms(
        lambda: torch.autograd.grad(ref_out, leaves, do, retain_graph=True), reps=10, warmup=2)
    del ref_out, leaves
    torch.cuda.empty_cache()
    return res


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


def _toy_train_config(load_config):
    return load_config({
        "model.hidden_dim": 64, "model.num_heads": 4, "model.dim_feedforward": 128,
        "model.num_transformer_encoder_layers": 1, "model.num_decoder_layers": 2,
        "model.compute_dtype": "float32", "model.dropout": 0.0, "model.goal_dropout": 0.0,
        "waymo.max_num_agents": 12, "sim.max_agents": 12, "waymo.train_context_length": 8,
        "waymo.max_num_road_polylines": 16, "waymo.max_num_road_pts_per_polyline": 20,
        "sim.steps": 16, "sim.resolve_contacts": False, "train.global_batch_size": 4,
        "train.accum_steps": 2, "train.lr": 5e-5,
    })


def _train_small_agreement() -> str:
    """One train step at a toy width on the card (K3/K4) and on the CPU
    (plain version) from the same params and batch. The state starts past
    the warmup, so the update moves every weight: at lr 5e-5 by at most
    about lr, which bounds what a sign flip of a near-zero gradient can do."""
    import torch

    from ctrl_sim_tpu_torch.config import load_config
    from ctrl_sim_tpu_torch.data import synthetic_scenario
    from ctrl_sim_tpu_torch.data.store import ScenarioStore
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.ops import flash_attention as fa
    from ctrl_sim_tpu_torch.params import init_params
    from ctrl_sim_tpu_torch.training import Trainer

    cfg = _toy_train_config(load_config)
    scenes = [synthetic_scenario(cfg, seed=SEED + s, num_agents=8, arena_half=60.0, num_lanes=2)
              for s in range(4)]
    store = ScenarioStore.from_scenes(cfg, scenes, device="cpu")
    batch = store.sample_batch(torch.Generator().manual_seed(SEED), cfg.train.global_batch_size)
    runs = {}
    for device in ("cpu", "cuda"):
        model = CtRLSim(cfg, device=device)
        init_params(model, torch.Generator().manual_seed(SEED))
        trainer = Trainer(cfg, device=device)
        state = trainer.state_from_model(model, step=cfg.train.warmup_steps)
        f0, b0 = fa.flash_mha_fwd.launches, fa.flash_mha_bwd.launches
        state, losses = trainer.make_train_step()(
            state, {k: v.to(device) for k, v in batch.items()}, torch.Generator(device=device).manual_seed(SEED))
        launched = (fa.flash_mha_fwd.launches - f0, fa.flash_mha_bwd.launches - b0)
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        runs[device] = (losses, grads, params, launched)
    (lc, gc, pc, _), (lg, gg, pg, launched) = runs["cpu"], runs["cuda"]
    expected = cfg.model.num_decoder_layers * cfg.train.accum_steps
    if launched != (expected, expected):
        raise AssertionError(f"toy train step launched K3/K4 {launched} times, expected {expected} each")
    loss_err = max(abs(float(a) - float(b)) for a, b in zip(lc, lg))
    gmax = max(g.abs().max().item() for g in gc.values())
    grad_err = max((gc[n] - gg[n]).abs().max().item() for n in gc) / gmax
    param_err = max((pc[n] - pg[n]).abs().max().item() for n in pc)
    if loss_err > 1e-4 or grad_err > 1e-4 or param_err > 1e-4:
        raise AssertionError(f"card and CPU train steps disagree: losses {loss_err}, gradients "
                             f"{grad_err} of max |grad|, params {param_err}")
    return (f"max |d loss| {loss_err:.3g}, |d grad| / max|grad| {grad_err:.3g}, |d param| {param_err:.3g}; "
            f"K3/K4 launches {launched}")


def _train_full(t_phase: float) -> dict:
    """The full-width training step (section 8 of the docstring)."""
    import torch

    from ctrl_sim_tpu_torch.ops import flash_attention as fa
    from ctrl_sim_tpu_torch.profile_train import SCENES, full_width_setup

    cfg, store, state, train_step, data_gen, dropout_gen, replay_s = full_width_setup(SEED)
    per_step = cfg.model.num_decoder_layers * cfg.train.accum_steps
    batch_ms, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_mha_fwd.launches = fa.flash_mha_bwd.launches = 0
    for i in range(TRAIN_STEPS):
        f0, b0 = fa.flash_mha_fwd.launches, fa.flash_mha_bwd.launches
        t0 = time.perf_counter()
        batch = store.sample_batch(data_gen, cfg.train.global_batch_size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, losses = train_step(state, batch, dropout_gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        batch_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        launched = (fa.flash_mha_fwd.launches - f0, fa.flash_mha_bwd.launches - b0)
        if launched != (per_step, per_step):
            raise AssertionError(f"train step {i} launched K3/K4 {launched} times, expected {per_step} each")
        values = [float(x) for x in losses] + [float(state.grad_norm)]
        if not all(map(math.isfinite, values)):
            raise AssertionError(f"train step {i}: non-finite loss or gradient norm {values}")
        print(f"  step {i + 1}: loss {values[0]:.4f} (actions {values[1]:.4f}, state {values[5]:.4f}), "
              f"grad norm {values[6]:.4f}, batch {batch_ms[-1]:.1f} ms, step {step_ms[-1]:.1f} ms", flush=True)
    launches = (fa.flash_mha_fwd.launches, fa.flash_mha_bwd.launches)
    peak = torch.cuda.max_memory_allocated()
    _phase("train", t_phase,
           f"{TRAIN_STEPS} steps of global batch {cfg.train.global_batch_size} = {cfg.train.accum_steps} x "
           f"{cfg.train.global_batch_size // cfg.train.accum_steps}, T = {cfg.waymo.train_context_length} x "
           f"{cfg.waymo.max_num_agents} x 3; replay of {SCENES} scenes {replay_s:.3f}s; step ms cold "
           f"{step_ms[0]:.1f}, steady median {statistics.median(step_ms[1:]):.1f}; batch build ms median "
           f"{statistics.median(batch_ms[1:]):.1f}; peak memory {peak / 2**30:.2f} GiB; K3/K4 launches {launches} "
           f"(one cold run on this card, not a benchmark)")
    return {"launches": launches}


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
    ft = _flash_main(gen)
    flash = {"train-step bfloat16 p=0.1": ft["check"]}
    for dtype in ("bfloat16", "float32"):
        for p in (0.0, 0.1):
            flash[f"train-shape {dtype} p={p}"] = _flash_case(4, 32, 24, 3, 8, 32, dtype, p, gen)
    flash["ragged bfloat16"] = _flash_case(4, 29, 23, 3, 8, 32, "bfloat16", 0.1, gen)
    flash["ragged float32"] = _flash_case(4, 29, 23, 3, 8, 32, "float32", 0.1, gen)
    flash["narrow bfloat16"] = _flash_case(4, 32, 24, 3, 4, 16, "bfloat16", 0.1, gen)
    for name, row in flash.items():
        print(f"  K3/K4 {name}: {row['shape']} output err {row['out_err']:.3g}, "
              f"gradient err {row['grad_err']:.3g} of max |grad| ({row['grad_abs_err']:.3g} absolute)")
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = ft["bound"]["fwd"], ft["bound"]["bwd"]
    print(f"  K3 forward, B=16 T=2304 H=256/8 bf16 p=0.1: kernel {ft['fwd_ms']:.4f} ms, bound "
          f"{fwd_bound:.4f} ms ({fwd_by}; {ft['bound']['pairs']} visible pairs), plain "
          f"{ft['plain_fwd_ms']:.4f} ms, library (SDPA, bool mask, p=0) {ft['library_fwd_ms']:.4f} ms")
    print(f"  K4 backward, same shape: kernel {ft['bwd_ms']:.4f} ms, bound {bwd_bound:.4f} ms ({bwd_by}), "
          f"plain (autograd) {ft['plain_bwd_ms']:.4f} ms, library (SDPA backward) "
          f"{ft['library_bwd_ms']:.4f} ms")
    _phase("k3-k4-vs-plain", t0, f"{len(flash)} cases within 2e-2 / 5e-2 (bf16), 1e-4 / 1e-4 (f32)")

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
    k1_launches = attention.cached_decode_attention.launches
    steps = cfg.sim.steps
    expected = 2 * cfg.model.num_decoder_layers * steps
    if k1_launches != expected:
        raise AssertionError(f"K1 launched {k1_launches} times on the main path, expected {expected}")
    for name, x in out._asdict().items():
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"non-finite rollout output {name}")
    if out.position.shape != (steps + 1, LANES, scenes.traj_position.shape[1], 2):
        raise AssertionError(f"unexpected position shape {tuple(out.position.shape)}")
    _phase("rollout", t0, f"{LANES} lanes x {steps} steps in {elapsed:.3f}s = "
           f"{LANES * steps / elapsed:.1f} env-steps/s on this card (one cold run, not a benchmark); "
           f"K1 launches {k1_launches}")
    del out, sc, model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    detail = _train_small_agreement()
    _phase("train-small-agreement", t0, detail)

    t0 = time.perf_counter()
    train = _train_full(t0)
    k3_launches, k4_launches = train["launches"]

    main_rows = [cases["pass1 bfloat16"], cases["pass2 bfloat16"]]  # the path's two shapes, 360 launches each
    mean = lambda key: statistics.fmean(r[key] for r in main_rows)  # noqa: E731
    main_flash = ft["check"]  # the inputs the kernels were timed on
    print(json.dumps({"kernels": [
        {
            "name": "cached_decode_attention",
            "route": "cuda",
            "source": "ctrl_sim_tpu_torch/csrc/decode_attention.cu",
            "replaces": "ctrl_sim_tpu/ops/attention.py:142",
            "launches": k1_launches,
            "max_abs_err": max(r["max_abs_err"] for r in main_rows),
            "ms": mean("ms"),
            "kernel_ms": mean("ms"),
            "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": main_rows[0]["bound_by"],
            "library_ms": mean("library_ms"),
            "build_s": build_s,
        },
        {
            "name": "flash_mha_fwd",
            "route": "cuda",
            "source": "ctrl_sim_tpu_torch/csrc/flash_attention.cu",
            "replaces": "ctrl_sim_tpu/ops/flash_attention.py:271",
            "launches": k3_launches,
            "max_abs_err": main_flash["out_err"],
            "ms": ft["fwd_ms"],
            "kernel_ms": ft["fwd_ms"],
            "plain_ms": ft["plain_fwd_ms"],
            "bound_ms": fwd_bound,
            "bound_by": fwd_by,
            "library_ms": ft["library_fwd_ms"],
            "shape": "B=16 T=2304 H=256/8 bf16 dropout 0.1",
        },
        {
            "name": "flash_mha_bwd",
            "route": "cuda",
            "source": "ctrl_sim_tpu_torch/csrc/flash_attention.cu",
            "replaces": "ctrl_sim_tpu/ops/flash_attention.py:299",
            "launches": k4_launches,
            "max_abs_err": main_flash["grad_abs_err"],
            "ms": ft["bwd_ms"],
            "kernel_ms": ft["bwd_ms"],
            "plain_ms": ft["plain_bwd_ms"],
            "bound_ms": bwd_bound,
            "bound_by": bwd_by,
            "library_ms": ft["library_bwd_ms"],
            "shape": "B=16 T=2304 H=256/8 bf16 dropout 0.1",
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
