#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

needs one CUDA card, nvcc and the checkout; it imports nothing of JAX. Phases,
each printing one line with its own seconds; any failure raises, so the exit
code is 0 only when every phase passed:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA kernel of the port, compiled by nvcc from the sources
   in the checkout (one nvcc per source, all started together), with
   ptxas's registers and spills per kernel, and the HMMA (tensor-core)
   instructions per kernel in the SASS of each library (``cuobjdump``):
   every bf16 K1, K2, K3 and K4 kernel must have some;
3. kernels K1 (decode attention) and K2 (decode attention over the int8
   cache) against their plain PyTorch versions on the card: the rollout's
   shapes (256 lanes, Q = 32 and 16 queries, N = 1536 keys, H = 256 = 8
   heads x 32) in bf16 and f32, a narrow case (H = 64 = 4 x 16, Q = 12) and
   a mask with fully masked rows; tolerance 2e-2 absolute in bf16, 1e-4 in
   f32; and ``quantize_rows`` on the card equal to its CPU result. Times
   (CUDA events around a run of 10 launches, median of 30 runs after
   warm-up; the plain versions one launch a run) of each kernel, its
   plain version and one library call, F.scaled_dot_product_attention,
   kept as a yardstick only (for K2 over the K/V dequantized to q's dtype
   beforehand: not the same function, and it reads twice K2's bytes);
   k1-k2-family-shapes: K1 (bf16 and f32) and K2 (bf16) the same way at
   the other families' shapes, under the masks that their rollouts give
   the first decode pass of step 45, recorded from ``run_streaming``
   (``rollout/setup.py:decode_masks``): DT Q = 48 over N = 1536 keys, IL 32
   over 1024, trajeglish 32 over 512, the 3-pass decode 16 over 1536, and
   its t - 1 action pass at t = 0, whose rows see no key (compared on
   every row: both versions give such a row the uniform average of V);
4. kernels K3/K4 (training flash attention, forward and backward; bf16 on
   the tensor cores, f32 on CUDA cores) against the plain version on the
   card: output, lse, dq, dk and dv at the train step's shape (B = 16,
   T = 32 x 24 x 3 = 2304, H = 256 = 8 x 32, bf16, dropout 0.1 and 0), then
   at that T and width with B = 4 in bf16 and f32 with dropout 0 and 0.1,
   and in bf16 and f32 a ragged T (29 x 23 x 3 = 2001), the strict mask
   (``attend_own_return_action``) and a sliding window, and in bf16 head
   widths 16 and 64, a ragged strict case at d = 64 and a windowed 2-token
   layout at d = 16: every case has partial tiles on the diagonal;
   tolerances 2e-2 absolute on outputs and 5e-2 of max |grad| on gradients
   in bf16, 1e-4 and 1e-4 in f32. Times of the kernels at dropout 0.1 and
   0, the plain version and the library yardstick (SDPA with the boolean
   [T, T] mask, at dropout 0) on the train step's B = 16 inputs;
   k3-k4-family-shapes: the same at the other families' train layouts, in
   bf16 at dropout 0 and 0.1, timed: B = 16 at T = 32 x 24 x 1 = 768
   (trajeglish) and T = 2304 with the state token second (DT), B = 4 at
   T = 1536 (IL);
5. golden-full: the forward at the deployed shape (hidden 256, 8 heads,
   2 + 4 layers, 24 agents x 32 steps, 200 x 100 road points) with the
   executed reference's weights (``tests/goldens/reference_model_full.npz``,
   loaded by ``utils/torch_import.py``) against its logits: f32 through
   K3's f32 kernel within 1e-4 + 1e-4 |ref|, and bf16 through the
   tensor-core K3 within 1.5 x the error of the same bf16 forward on the
   plain einsum attention; golden-families: the f32 forward of DT, IL and
   trajeglish with the executed reference's weights
   (``tests/goldens/reference_model.npz``) through K3's f32 kernel against
   its logits within 1e-4 + 1e-4 |ref|;
6. small-input agreement: the streaming rollout at a toy width with
   contacts on, with the bf16-width cache (K1) and the int8 cache (K2), on
   the card, replaying the draws of the same rollout on the CPU, agrees
   with it; families-small-agreement: the same for DT, IL, trajeglish and
   the 3-pass decode;
7. the rollouts at full width: random weights from a seeded generator
   (hidden 256, 8 heads, FF 1024, 2 + 4 layers, bf16 compute, bf16
   cross-attention scores), 256 synthetic scenes of 12 agents packed into
   16 slots, ``run_streaming`` for 90 steps with contacts on (bench.py's
   default), first with the bf16 cache and then, on the same scenes and
   weights, with the int8 cache (``BENCH_KV=int8``), and last with the
   bf16 cache and contacts off, for the solver's share of the time; every
   output finite, and K1, K2, K1 launched exactly 2 passes x 4 layers x 90
   steps = 720 times; families-rollout: the same scenes through DT, IL and
   trajeglish (each with weights of its own from the seed), DT with the
   int8 cache and the default family's 3-pass decode, their kernel
   launched 1 pass x 4 layers x 90 steps = 360 times (3-pass: 1080) and the
   other decode kernel never;
8. train-small-agreement: one train step at a toy width (f32, dropout and
   goal dropout 0) from the same params and batch on the card (K3/K4) and
   on the CPU (plain version): losses, gradients and updated params within
   1e-4;
9. train at full width: the default model with dropout 0.1, 64 synthetic
   scenes of 12 agents replayed through physics (contacts on) into a
   ``ScenarioStore``, 10 steps of ``Trainer.make_train_step`` at global
   batch 64 as 16 x 4 accumulation; every loss and the gradient norm
   finite, and exactly 4 layers x 4 microbatches = 16 K3 and 16 K4
   launches per step; families-train: 3 such steps of DT, IL and
   trajeglish on the same store, with the same checks;
10. the exact rollout and the evaluators. eval-small-agreement:
   ``run_closed_loop`` at a toy width (f32, contacts on) on the card
   against the same rollout on the CPU under its replayed draws, for
   CtRL-Sim, DT and a scene of 20 agents in two or more focal groups
   (tolerances of small-agreement); eval-exact: ``PolicyEvaluator`` in
   multi_agent mode at full width (the default model, seeded weights,
   bf16, contacts on) on one chunk of the 32 synthetic scenes of 12 agents
   that ``eval_sim --synthetic 32`` evaluates, 90 steps
   (``rollout/setup.py:exact_eval_setup``; 3-6 focal groups a scene, the
   chunk padded to the most): K3 launched exactly 2 passes x 4 layers x 90
   steps = 720 times, K4, K1 and K2 never, the tile table built at most
   once, every metric finite, rates in [0, 1], JSDs at most sqrt(ln 2);
   its wall seconds, peak memory and focal groups a scene; then K3 at that
   decode shape (B = scenes x groups, T = 2304, dropout 0, forward only),
   and at B = 32 (one group a scene), against its plain version within
   2e-2, timed beside its bound and SDPA, and a launch under
   ``torch.inference_mode`` that keeps nothing for a backward;
   eval-multigroup: 8 scenes of 40 agents (G >= 2 focal groups),
   and the same chunk padded to G + 1 under the same draws, with equal
   metrics, and K3 at its B = 8 G the same way; eval-streaming: the
   eval-exact scenes through the streaming rollout (episode-start frames,
   16 slots; K1 720 times); eval-planner:
   ``PlannerAdversaryEvaluator`` on 8 scenes with crossing pairs, exact,
   per-agent tilts, one adversary replaying a CAT attack path; finetune: 3 full-width train
   steps on a ``FinetuningStore`` of the training store and 16 CAT scenes
   (16 K3 and 16 K4 launches a step, losses finite);
11. the trained checkpoint and real scene data. trained-weights: r05_s0
   (``artifacts/torch/r05_s0``, converted from the orbax checkpoint by
   ``tools/convert_checkpoints_to_torch.py``; f32, hidden 64, 4 heads of
   16, 2 decoder layers) restored on the card and on the CPU, the training
   forward's heads on the same held-out scenes within 1e-4 (K3's f32
   kernel, one launch a layer); tilt-sweep: the artifact's recipe (256
   held-out scenes from seed 1000 with one crossing pair, streaming, 32
   lanes a chunk, veh-veh tilts -50, 0, 10), K1 launched 2 passes x 2
   layers x 40 steps a chunk, and each of goal, collision rate and ADE
   held to ``artifacts/eval_r05_tilt_sweep.json`` (``veh_conflict``, seeds 0
   and 1): within the larger of 3 x |seed0 - seed1|, 3 binomial standard
   errors over the controlled agents (rates) and 5% of the mean (ADE); ADE
   at -50 above ADE at 10; then K1 at r05's decode shape against its plain
   version, timed (the kernel alone: ten raw launches captured in a CUDA
   graph); planner-adversary-trained: 64 such scenes with two crossing
   pairs, adversary tilts -10 and -50, at the eval seeds of
   ``artifacts/torch/eval_r05_planner_jax_seeds.json`` (the JAX package's
   readings, ``tools/r05_planner_seed_spread.py``), the card's means of
   ``ego_cr_w_adv`` and ``adv_coll_speed`` within 3 standard errors of the
   difference of two means (from both spreads; for the rate at least the
   binomial one) of the JAX package's, and
   ``artifacts/eval_r05_planner.json`` (one JAX run) printed beside them;
   examples: ``examples/torch_*.py`` as
   subprocesses, exit 0; json-data: 64 scenes of the default config
   written in the raw dialect and, replayed, the physics dialect, read by
   the Python and the native loader (files/s, fields equal),
   ``train.py --data_dir --val_dir`` for 3 full-width steps (16 K3 and 16
   K4 a step, 4 K3 for the validation), ``eval_sim.py --data_dir``
   streaming (K1) and exact (K3), and the focal groups of the loaded
   scenes. Head widths without a kernel instance (d = 8 and 48, each head
   zero-padded to 16 and 64) are held in k1-vs-plain, k2-vs-plain and
   k3-k4-vs-plain, and K3/K4 timed at them beside their plain version and
   SDPA;
12. the CTG++ diffusion family, whose path reaches none of K1-K4: each
   phase zeroes the launch counts first and fails if any of K1-K4 ran.
   ctg-golden-full: the DiT at the preset's full width (hidden 256, 8
   heads, 24 agents, horizon 10 + 22, 200 x 100 road crops) in f32 with the
   executed reference's weights (``tests/goldens/reference_ctg_full.npz``,
   through the port's importer) against its output within 5e-4 + 1e-4
   |ref|; ctg-small-agreement: the toy CTGPlusPlus (seeded weights) on the
   card against the CPU on one CTG++ batch and the same draws (forward,
   loss, unguided and guided sample) in f32 within 1e-4, and the forward
   and loss in bf16 within 2e-2 (the bf16 samples' card-vs-CPU gap is
   printed, not held: the rounding of 10 compounding bf16 denoiser steps is
   of the size of the CPU's own bf16-vs-f32 gap, printed beside it);
   ctg-eval: ``eval_sim --preset ctg_plus_plus --synthetic
   32`` at full width with seeded weights (90 steps, contacts on, 17
   replans of 50 denoiser calls), metrics finite and in range, its wall,
   time per replan and peak memory, then again under torch.profiler for
   the device's busy share, and one replan's device time by kernel;
   ctg-train: ``train.py --preset ctg_plus_plus`` for 5 full-width steps
   (global batch 64 as 2 x 32), losses finite, ms per step and peak
   memory, and one step's device time by kernel; ctg-import: the
   reference-layout import CLI on the small golden's CTG++ weights,
   restored on the card, within 2e-4 + 1e-4 |ref| of the reference.

Then one line ``{"kernels": [...]}``, each kernel's row with its times
at the other families' shapes under ``family_shapes`` and K3's at the
exact rollout's under ``exact_eval_shape`` (B = the eval-exact chunk's
scenes x groups), ``exact_eval_one_group_shape`` (B = 32) and
``multigroup_eval_shape`` (B = 8 G), each row's ``head_width_cases``, K1's
``r05_shape``, and, last, the device line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
TRAIN_STEPS = 10
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet, dense rates below too)
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; fp32 outside them
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}  # of max |grad|
PLAIN_LANES = 32  # lanes a call of K3's plain version at the exact rollout's shape (5.4 GB of fp32 scores)
IMPLEMENTATION = ("bf16: tensor cores, mma.sync m16n8k16 with fp32 accumulators, 64-row tiles, cp.async "
                  "ring, mask only on partial tiles; f32: CUDA cores")
DECODE_IMPLEMENTATION = ("bf16: tensor cores, mma.sync m16n8k16 with fp32 accumulators; a warp per (lane, head, "
                         "16 or 32 query rows) streams all its keys in 32-key chunks through its own cp.async "
                         "ring of swizzled tiles, 4 heads of a lane a block; f32: CUDA cores")
# the bf16 kernels of each source, which must run on the tensor cores (HMMA in their SASS)
MMA_KERNELS = {
    "decode_attention.cu": ("decode_attention_mma_kernel",),
    "decode_attention_q8.cu": ("decode_attention_q8_mma_kernel",),
    "flash_attention.cu": ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel", "flash_bwd_dkdv_mma_kernel"),
}
# the executed reference at the deployed shape (tools/make_model_goldens.py --full)
GOLDEN = Path(__file__).resolve().parent / "tests" / "goldens" / "reference_model_full.npz"
GOLDEN_CONFIG = {
    "model.hidden_dim": 256, "model.num_heads": 8, "model.dim_feedforward": 1024,
    "model.num_transformer_encoder_layers": 2, "model.num_decoder_layers": 4, "model.remat": False,
    "waymo.train_context_length": 32, "waymo.max_num_agents": 24,
    "waymo.max_num_road_polylines": 200, "waymo.max_num_road_pts_per_polyline": 100,
}
# the executed reference of each family at a small width (tools/make_model_goldens.py)
FAMILY_GOLDEN = GOLDEN.with_name("reference_model.npz")
FAMILY_GOLDEN_CONFIG = {
    "model.hidden_dim": 64, "model.num_heads": 4, "model.dim_feedforward": 128,
    "model.num_transformer_encoder_layers": 2, "model.num_decoder_layers": 2, "model.remat": False,
    "model.predict_rtg": False, "model.predict_future_states": False, "model.compute_dtype": "float32",
    "waymo.train_context_length": 4, "waymo.max_num_agents": 4,
    "waymo.max_num_road_polylines": 6, "waymo.max_num_road_pts_per_polyline": 10,
}
FAMILY_FLAGS = {"dt": "model.decision_transformer", "il": "model.il", "trajeglish": "model.trajeglish"}
FAMILY_TRAIN_STEPS = 3
WIDTH_CASES = (8, 48)  # head widths without a kernel instance (padded to 16 and 64)


def _phase(name: str, t0: float, detail: str = "") -> None:
    print(f"[{name}] {time.perf_counter() - t0:.2f}s {detail}".rstrip(), flush=True)


def _kernel_label(mangled: str) -> str:
    """``flash_fwd_mma_kernel<32, 4>`` (or ``flash_fwd_kernel<float, 32>``)
    from a kernel's mangled name: the last of its length-prefixed names
    (after the namespace's), then its template arguments."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while (m := re.match(r"\d+", mangled[i:])):
        start = i + m.end()
        i = start + int(m.group())
        name = mangled[start:i]
    t = re.match(r"I(f)?(?:13__nv_bfloat16)?((?:Li\d+E)+)", mangled[i:])
    if not t:
        return name
    return f"{name}<{'float, ' if t.group(1) else ''}{', '.join(re.findall(r'Li(\d+)E', t.group(2)))}>"


def _ptxas_lines(report: str):
    """(kernel, line) for each register and spill line of nvcc's ptxas report."""
    kernel = "?"
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            kernel = _kernel_label(m.group(1))
        if "registers" in line or "spill" in line:
            yield kernel, line.split(":", 1)[-1].strip()


def _hmma_counts(library) -> dict[str, int]:
    """HMMA (tensor-core) instructions per kernel in the SASS of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = _kernel_label(m.group(1))
            counts[kernel] = 0
        elif kernel and "HMMA" in line:
            counts[kernel] += 1
    return counts


def _median_ms(fn, reps: int = 30, warmup: int = 5, batch: int = 10) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``batch`` calls
    in a row, the median of ``reps`` such runs. A run of calls keeps the
    host's time to enqueue one call (tens of microseconds in a wrapper) out
    of a kernel's time, as long as it is shorter than the kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def _graph_ms(fn, reps: int = 30, batch: int = 10) -> float:
    """Milliseconds per call of ``fn`` on the device alone: ``batch`` calls
    captured in one CUDA graph, the median of ``reps`` timed replays. For
    calls shorter than the host's time to enqueue them, which a run of
    eager calls (``_median_ms``) would time instead."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def _attention_case(B, Q, N, H, heads, dtype, mask, gen, int8=False, graph=False):
    """K1 (or, with ``int8``, K2 over a cache quantized from unit normals by
    ``quantize_rows``) against its plain version on one input; returns the
    measured row. The library yardstick for K2 runs over the K/V
    dequantized to q's dtype beforehand. With ``graph`` (K1 at a width it
    is built for), ``ms`` and ``library_ms`` time the kernel's raw launch
    and SDPA in a CUDA graph (``_graph_ms``), and ``wrapper_ms`` the eager
    wrapper as the other rows do."""
    import torch
    import torch.nn.functional as F

    from ctrl_sim_tpu_torch.ops import attention

    dt = getattr(torch, dtype)
    q = torch.randn((B, Q, H), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, N, H), generator=gen, device="cuda") for _ in range(2))
    if int8:
        (k, ks), (v, vs) = attention.quantize_rows(k), attention.quantize_rows(v)
        args = (q, k, v, ks, vs, mask, heads)
        kernel, plain = attention.cached_decode_attention_q8, attention.cached_decode_attention_q8_reference
        k_lib, v_lib = (x.float() * s[..., None] for x, s in ((k, ks), (v, vs)))
    else:
        k, v = k.to(dt), v.to(dt)
        args = (q, k, v, mask, heads)
        kernel, plain = attention.cached_decode_attention, attention.cached_decode_attention_reference
        k_lib, v_lib = k, v
    name = "K2" if int8 else "K1"
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    rows = (mask != 0).any(dim=1)  # rows with a visible key; the others are unused
    if not rows.any():
        # a pass whose rows all see no key (the 3-pass decode's t - 1 actions at t = 0): both
        # versions give each row the uniform average of V, so every row is compared
        rows = ~rows
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} gave non-finite values at B={B} Q={Q} N={N} H={H} {dtype}")
    err = (got.float() - want.float())[:, rows].abs().max().item()
    if err > TOL[dtype]:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {TOL[dtype]}")

    d = H // heads
    q4, k4, v4 = (x.to(dt).view(x.shape[0], x.shape[1], heads, d).transpose(1, 2) for x in (q, k_lib, v_lib))
    bool_mask = mask != 0
    kv_bytes = 2 * B * N * H * (1 if int8 else q.element_size()) + (2 * B * N * 4 if int8 else 0)
    nbytes = 2 * B * Q * H * q.element_size() + kv_bytes + Q * N
    ops = 4 * B * Q * N * H
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    row = {
        "shape": f"B={B} Q={Q} N={N} H={H}/{heads} {dtype}" + (" int8 K/V" if int8 else ""),
        "max_abs_err": err,
        "ms": _median_ms(lambda: kernel(*args)),
        "plain_ms": _median_ms(lambda: plain(*args), batch=1),
        "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bool_mask)),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    if graph:
        row.update(_k1_graph_times(q, k, v, mask, heads, got, q4, k4, v4, bool_mask))
    return row


def _k1_graph_times(q, k, v, mask, heads, got, q4, k4, v4, bool_mask) -> dict:
    """K1's raw launch (the wrapper's pre-scale and mask cast done once,
    outside) and SDPA, each timed in a CUDA graph; the raw launch's output
    must equal the wrapper's."""
    import torch
    import torch.nn.functional as F

    from ctrl_sim_tpu_torch.ops import attention
    from ctrl_sim_tpu_torch.ops.heads import KERNEL_HEAD_DIMS

    B, Q, H = q.shape
    N = k.shape[1]
    if H // heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the raw launch takes no padded head width (d = {H // heads})")
    fn = attention._kernel("decode_attention.cu", "ctrl_sim_decode_attention", 5)
    qs = attention._prescale(q, heads).contiguous()
    mask_i8 = torch.nn.functional.pad(mask.to(torch.int8), (0, N % 2)).contiguous()
    out = torch.empty_like(qs)

    def launch():
        err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i8.data_ptr(), out.data_ptr(), B, Q, N, H, heads,
                 int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"decode attention kernel launch failed: cudaError_t {err}")

    ms = _graph_ms(launch)
    if not torch.equal(out, got):
        raise AssertionError("K1's raw launch differs from its wrapper's output")
    return {"wrapper_ms": _median_ms(lambda: attention.cached_decode_attention(q, k, v, mask, heads)), "ms": ms,
            "library_ms": _graph_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bool_mask)),
            "timed": "ms and library_ms: 10 calls in a CUDA graph, device only; wrapper_ms: eager wrapper calls"}


def _quantize_rows_on_card(gen) -> str:
    """``quantize_rows`` on the card equals its CPU result, values and
    scales bit for bit (every step is exact or correctly rounded)."""
    import torch

    from ctrl_sim_tpu_torch.ops import attention
    from ctrl_sim_tpu_torch.rollout.setup import LANES

    x = torch.randn((LANES, 1536, 256), generator=gen, device="cuda") * 3
    for dtype in (torch.float32, torch.bfloat16):
        got = attention.quantize_rows(x.to(dtype))
        want = attention.quantize_rows(x.to(dtype).cpu())
        for name, a, b in zip(("values", "scales"), got, want):
            if not torch.equal(a.cpu(), b):
                diff = (a.cpu().float() - b.float()).abs().max().item()
                raise AssertionError(f"quantize_rows {name} on the card differ from the CPU's ({dtype}): {diff}")
    return f"quantize_rows of {tuple(x.shape)} equal to the CPU's in f32 and bf16"


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


def _flash_case(B, steps, A, K, heads, d, dtype, dropout_p, gen, own=False, window=None):
    import torch

    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(B, steps, A, K, heads, d, getattr(torch, dtype), gen)
    row = _flash_compare(q, k, v, do, fa.MaskSpec(A, K, 0, own, window), heads, dropout_p,
                         torch.tensor([0x5EED], device="cuda"))
    if own or window:
        row["shape"] += f" own={own} window={window}"
    return row


def _flash_family_case(B, K, state_index, dropout_p, gen):
    """K3/K4 against the plain version at a family's train-step layout (32
    steps x 24 agents x K token types, H = 256 = 8 x 32, bf16), then timed,
    with their bounds."""
    import torch

    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(B, 32, 24, K, 8, 32, torch.bfloat16, gen)
    spec, seed = fa.MaskSpec(24, K, state_index, False, None), torch.tensor([11], device="cuda")
    row = _flash_compare(q, k, v, do, spec, 8, dropout_p, seed)
    row["shape"] += f" K={K} state_index={state_index}"
    out, lse = fa.flash_mha_fwd(q, k, v, spec, 8, dropout_p, seed)
    row["fwd_ms"] = _median_ms(lambda: fa.flash_mha_fwd(q, k, v, spec, 8, dropout_p, seed))
    row["bwd_ms"] = _median_ms(lambda: fa.flash_mha_bwd(q, k, v, out, do, lse, spec, 8, dropout_p, seed))
    bounds = _flash_bounds(B, q.shape[1], 256, 8, spec, "bfloat16")
    row["fwd_bound_ms"], row["bwd_bound_ms"] = bounds["fwd"][0], bounds["bwd"][0]
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    return row


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

    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    B, steps, A, K, heads, d = 16, 32, 24, 3, 8, 32
    spec = fa.MaskSpec(A, K, 0, False, None)
    seed = torch.tensor([7], device="cuda")
    q, k, v, do = _flash_inputs(B, steps, A, K, heads, d, torch.bfloat16, gen)
    T = q.shape[1]
    res = {"check": _flash_compare(q, k, v, do, spec, heads, 0.1, seed),
           "check_p0": _flash_compare(q, k, v, do, spec, heads, 0.0, seed),
           "bound": _flash_bounds(B, T, heads * d, heads, spec, "bfloat16")}
    torch.cuda.empty_cache()
    for p, tag in ((0.1, ""), (0.0, "_p0")):
        out, lse = fa.flash_mha_fwd(q, k, v, spec, heads, p, seed)
        res["fwd_ms" + tag] = _median_ms(lambda: fa.flash_mha_fwd(q, k, v, spec, heads, p, seed))
        res["bwd_ms" + tag] = _median_ms(lambda: fa.flash_mha_bwd(q, k, v, out, do, lse, spec, heads, p, seed))

    res.update(_flash_plain_and_library_ms(q, k, v, do, spec, heads, 0.1, seed))
    return res


def _flash_plain_and_library_ms(q, k, v, do, spec, heads, dropout_p, seed) -> dict:
    """Times, on the same inputs, of the plain version (forward at
    ``dropout_p``, runs of one call; backward by autograd) and of the
    library yardstick (SDPA with the boolean [T, T] mask at dropout 0,
    forward and backward)."""
    import torch
    import torch.nn.functional as F

    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    B, T, D = q.shape
    d = D // heads
    res = {}
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
            lambda: fa.flash_mha_reference(q, k, v, spec, heads, dropout_p, seed), reps=10, warmup=2, batch=1)
    ref_out, _ = fa.flash_mha_reference(*leaves, spec, heads, dropout_p, seed)
    res["plain_bwd_ms"] = _median_ms(
        lambda: torch.autograd.grad(ref_out, leaves, do, retain_graph=True), reps=10, warmup=2, batch=1)
    del ref_out, leaves
    torch.cuda.empty_cache()
    return res


def _golden_full() -> str:
    """The forward at the deployed shape against the executed reference
    (``tests/goldens/reference_model_full.npz``), with its weights loaded
    through the port's importer: f32 through K3's f32 kernel within the
    CPU test's 1e-4, and bf16 through the tensor-core K3, whose error must
    stay within 1.5 x that of the same bf16 forward on the plain einsum
    attention."""
    import numpy as np
    import torch

    from ctrl_sim_tpu_torch.config import load_config
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.params import from_flax_params
    from ctrl_sim_tpu_torch.utils.torch_import import golden_batch, golden_state, params_from_torch_state

    g = np.load(GOLDEN)
    names = ("action_preds", "rtg_preds", "state_preds")
    want = {n: torch.as_tensor(g[f"full_out_{n}"], device="cuda") for n in names}
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in golden_batch(g, "full").items()}
    state = golden_state(g, "full")
    errs = {}
    for dtype, flash in (("float32", True), ("bfloat16", True), ("bfloat16", False)):
        cfg = load_config({**GOLDEN_CONFIG, "model.compute_dtype": dtype, "model.use_flash_attention": flash})
        model = CtRLSim(cfg)
        model.load_state_dict(from_flax_params(params_from_torch_state(state, cfg)), strict=True)
        model.eval()
        _zero_counts()
        with torch.no_grad():
            out = model(batch)
        torch.cuda.synchronize()
        _expect_counts(f"golden forward {dtype} flash={flash}",
                       (cfg.model.num_decoder_layers if flash else 0, 0, 0, 0))
        got = {n: getattr(out, n).float() for n in names}
        if not all(torch.isfinite(x).all() for x in got.values()):
            raise AssertionError(f"golden forward {dtype} flash={flash}: non-finite outputs")
        errs[dtype, flash] = max((got[n] - want[n]).abs().max().item() for n in names)
        if dtype == "float32":
            excess = max(((got[n] - want[n]).abs() - 1e-4 - 1e-4 * want[n].abs()).max().item() for n in names)
            if excess > 0:
                raise AssertionError(f"golden forward f32 (K3 f32 kernel) off the reference by "
                                     f"{errs[dtype, flash]}: beyond 1e-4 + 1e-4 |ref| by {excess}")
        del model, out
    ratio = errs["bfloat16", True] / errs["bfloat16", False]
    if ratio > 1.5:
        raise AssertionError(f"golden forward bf16: K3 (tensor cores) error {errs['bfloat16', True]} is "
                             f"{ratio:.3f} x the plain attention's {errs['bfloat16', False]} (limit 1.5)")
    return (f"B=1 T=2304 H=256/8, reference weights; max |d logits| f32 via K3 f32 {errs['float32', True]:.3g} "
            f"(within 1e-4 + 1e-4 |ref|); bf16 via K3 tensor cores {errs['bfloat16', True]:.4g}, bf16 plain "
            f"attention {errs['bfloat16', False]:.4g}, ratio {ratio:.3f} (limit 1.5)")


def _golden_families() -> str:
    """The f32 forward of DT, IL and trajeglish with the executed
    reference's weights (``tests/goldens/reference_model.npz``) on the card,
    its self-attention through K3's f32 kernel, against the reference's
    logits within the CPU test's 1e-4 + 1e-4 |ref|."""
    import numpy as np
    import torch

    from ctrl_sim_tpu_torch.config import load_config
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.params import from_flax_params
    from ctrl_sim_tpu_torch.utils.torch_import import golden_batch, golden_state, params_from_torch_state

    g = np.load(FAMILY_GOLDEN)
    errs = []
    for family, flag in FAMILY_FLAGS.items():
        cfg = load_config({**FAMILY_GOLDEN_CONFIG, flag: True, "model.use_flash_attention": True})
        model = CtRLSim(cfg)
        model.load_state_dict(from_flax_params(params_from_torch_state(golden_state(g, family), cfg)), strict=True)
        model.eval()
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in golden_batch(g, family).items()}
        want = torch.as_tensor(g[f"{family}_out_action_preds"], device="cuda")
        _zero_counts()
        with torch.no_grad():
            out = model(batch)
        torch.cuda.synchronize()
        _expect_counts(f"golden {family}", (cfg.model.num_decoder_layers, 0, 0, 0))
        if out.rtg_preds is not None or out.state_preds is not None:
            raise AssertionError(f"golden {family}: the family has no RTG or future-state head")
        got = out.action_preds.float()
        err = (got - want).abs().max().item()
        excess = ((got - want).abs() - 1e-4 - 1e-4 * want.abs()).max().item()
        if not torch.isfinite(got).all() or excess > 0:
            raise AssertionError(f"golden {family} (K3 f32 kernel) off the reference by {err}: beyond 1e-4 + "
                                 f"1e-4 |ref| by {excess}")
        errs.append(f"{family} {err:.3g}")
    return ("T = 4 x 4 x K, H = 64/4, reference weights, f32 via K3 f32; max |d action logits| "
            + ", ".join(errs) + " (within 1e-4 + 1e-4 |ref|)")


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


def _small_agreement(family: str = "ctrl_sim", extra: dict | None = None, exact: bool = False,
                     groups: bool = False) -> str:
    """The toy-width rollout (contacts on) of a model family (with
    ``extra`` overrides) on the card against the same rollout on the CPU
    (plain kernels), with the CPU run's draws replayed on the card: the
    streaming rollout in 8 packed slots, or with ``exact`` the exact
    rollout ``run_closed_loop``; ``groups``: 20 agents a scene over the
    12-slot crop, in two or more focal groups."""
    import numpy as np
    import torch

    from ctrl_sim_tpu_torch.config import _set_dotted, preset
    from ctrl_sim_tpu_torch.data import stack_scenarios, synthetic_scenario, to_torch
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.params import init_params
    from ctrl_sim_tpu_torch.rollout.groups import build_focal_groups
    from ctrl_sim_tpu_torch.rollout.policy import PolicySampler
    from ctrl_sim_tpu_torch.rollout.rollout import run_closed_loop
    from ctrl_sim_tpu_torch.rollout.streaming import run_streaming

    agents = 20 if groups else 8
    cfg = preset(family)
    for key, value in {
        "model.hidden_dim": 64, "model.num_heads": 4, "model.dim_feedforward": 128,
        "model.num_transformer_encoder_layers": 1, "model.num_decoder_layers": 2,
        "model.compute_dtype": "float32", "waymo.max_num_agents": 12, "sim.max_agents": max(agents, 12),
        "eval.agent_slots": 0 if exact else 8, "waymo.train_context_length": 8, "sim.steps": 16,
        "sim.history_steps": 4, **(extra or {}),
    }.items():
        cfg = _set_dotted(cfg, key, value)
    scenes = stack_scenarios(
        [synthetic_scenario(cfg, seed=SEED + s, num_agents=agents, arena_half=60.0, num_lanes=2)
         for s in range(4)], cfg)
    controlled = scenes.moving & scenes.agent_valid
    runs, G = {}, 1
    for device in ("cpu", "cuda"):
        model = CtRLSim(cfg, device=device)
        init_params(model, torch.Generator().manual_seed(SEED))
        sc = to_torch(scenes, device)
        if device == "cpu":
            sampler = _RecordingSampler(PolicySampler(cfg, torch.Generator().manual_seed(SEED)))
        else:
            sampler = _ReplaySampler(runs["cpu"][1].rtg, runs["cpu"][1].act, device)
        spec = None
        if groups:
            spec = build_focal_groups(cfg, scenes.traj_position, scenes.traj_valid.astype(bool),
                                      scenes.agent_valid.astype(bool), controlled, device=device)
            G = spec.num_groups
            if G < 2:
                raise AssertionError(f"expected two or more focal groups a scene, got {G}")
        rollout = run_closed_loop if exact else run_streaming
        out = rollout(cfg, model, sc, torch.as_tensor(np.asarray(controlled), device=device), None,
                      groups=spec, sampler=sampler)
        runs[device] = (out, sampler)
    (cpu, cs), (gpu, gs) = runs["cpu"], runs["cuda"]
    logit_err = max((a - b).abs().max().item() for a, b in zip(cs.logits, gs.logits))
    pos_err = (cpu.position - gpu.position.cpu()).abs().max().item()
    rew_err = (cpu.reward8 - gpu.reward8.cpu()).abs().max().item()
    if logit_err > 1e-3 or pos_err > 1e-3 or rew_err > 1e-3:
        raise AssertionError(
            f"card and CPU rollouts disagree: logits {logit_err}, positions {pos_err}, reward8 {rew_err}")
    label = f"{family} {extra}" if extra else family
    if groups:
        label += f", {G} groups"
    return (f"{label}: max |d action logits| {logit_err:.3g}, |d position| {pos_err:.3g}, "
            f"|d reward8| {rew_err:.3g}")


def _toy_train_config(load_config):
    return load_config({
        "model.hidden_dim": 64, "model.num_heads": 4, "model.dim_feedforward": 128,
        "model.num_transformer_encoder_layers": 1, "model.num_decoder_layers": 2,
        "model.compute_dtype": "float32", "model.dropout": 0.0, "model.goal_dropout": 0.0,
        "waymo.max_num_agents": 12, "sim.max_agents": 12, "waymo.train_context_length": 8,
        "waymo.max_num_road_polylines": 16, "waymo.max_num_road_pts_per_polyline": 20,
        "sim.steps": 16, "train.global_batch_size": 4,
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
        _zero_counts()
        state, losses = trainer.make_train_step()(
            state, {k: v.to(device) for k, v in batch.items()}, torch.Generator(device=device).manual_seed(SEED))
        torch.cuda.synchronize()
        launched = _counts()[:2]
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        runs[device] = (losses, grads, params, launched)
    (lc, gc, pc, cpu_launched), (lg, gg, pg, launched) = runs["cpu"], runs["cuda"]
    expected = cfg.model.num_decoder_layers * cfg.train.accum_steps
    if cpu_launched != (0, 0) or launched != (expected, expected):
        raise AssertionError(f"toy train step launched K3/K4 {launched} times on the card and {cpu_launched} on "
                             f"the CPU, expected {expected} each and none")
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

    from ctrl_sim_tpu_torch.profile_train import SCENES, full_width_setup

    cfg, store, state, train_step, data_gen, dropout_gen, replay_s = full_width_setup(SEED)
    per_step = cfg.model.num_decoder_layers * cfg.train.accum_steps
    batch_ms, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        _zero_counts()
        t0 = time.perf_counter()
        batch = store.sample_batch(data_gen, cfg.train.global_batch_size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, losses = train_step(state, batch, dropout_gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        batch_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        _expect_counts(f"train step {i}", (per_step, per_step, 0, 0))
        values = [float(x) for x in losses] + [float(state.grad_norm)]
        if not all(map(math.isfinite, values)):
            raise AssertionError(f"train step {i}: non-finite loss or gradient norm {values}")
        print(f"  step {i + 1}: loss {values[0]:.4f} (actions {values[1]:.4f}, state {values[5]:.4f}), "
              f"grad norm {values[6]:.4f}, batch {batch_ms[-1]:.1f} ms, step {step_ms[-1]:.1f} ms", flush=True)
    launches = (TRAIN_STEPS * per_step, TRAIN_STEPS * per_step)  # each step's counts held above
    peak = torch.cuda.max_memory_allocated()
    _phase("train", t_phase,
           f"{TRAIN_STEPS} steps of global batch {cfg.train.global_batch_size} = {cfg.train.accum_steps} x "
           f"{cfg.train.global_batch_size // cfg.train.accum_steps}, T = {cfg.waymo.train_context_length} x "
           f"{cfg.waymo.max_num_agents} x 3; replay of {SCENES} scenes {replay_s:.3f}s; step ms cold "
           f"{step_ms[0]:.1f}, steady median {statistics.median(step_ms[1:]):.1f}; batch build ms median "
           f"{statistics.median(batch_ms[1:]):.1f}; peak memory {peak / 2**30:.2f} GiB; K3/K4 launches {launches} "
           f"(one cold run on this card, not a benchmark)")
    return {"launches": launches, "store": store}


def _train_families(store) -> dict:
    """``FAMILY_TRAIN_STEPS`` full-width train steps of DT, IL and
    trajeglish (dropout 0.1, global batch 64 as 16 x 4, the default
    family's store of replayed scenes): every loss finite, and K3/K4
    launched 4 layers x 4 microbatches = 16 times each per step."""
    import torch

    from ctrl_sim_tpu_torch.profile_train import full_width_setup

    rows = {}
    for family in FAMILY_FLAGS:
        cfg, store, state, train_step, data_gen, dropout_gen, _ = full_width_setup(SEED, family, store)
        per_step = cfg.model.num_decoder_layers * cfg.train.accum_steps
        step_ms = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        for i in range(FAMILY_TRAIN_STEPS):
            batch = store.sample_batch(data_gen, cfg.train.global_batch_size)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses = train_step(state, batch, dropout_gen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            values = [float(x) for x in losses] + [float(state.grad_norm)]
            if not all(map(math.isfinite, values)) or values[0] <= 0:
                raise AssertionError(f"{family} train step {i}: non-finite or zero loss or gradient norm {values}")
        expected = FAMILY_TRAIN_STEPS * per_step
        _expect_counts(f"{family}: {FAMILY_TRAIN_STEPS} train steps", (expected, expected, 0, 0))
        launches = (expected, expected)
        T = cfg.waymo.train_context_length * cfg.waymo.max_num_agents * cfg.model.num_token_types
        rows[family] = {"T": T, "launches_per_step": launches[0] // FAMILY_TRAIN_STEPS, "step_ms": step_ms,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "loss": values[0]}
        print(f"  {family}: T = {T}, loss {values[0]:.4f}, step ms {', '.join(f'{x:.1f}' for x in step_ms)} "
              f"(steady median {statistics.median(step_ms[1:]):.1f}), peak memory "
              f"{rows[family]['peak_gib']:.2f} GiB, K3/K4 launches {launches}", flush=True)
        del state, train_step
        torch.cuda.empty_cache()
    return rows


def _counts() -> tuple[int, int, int, int]:
    """Launches of K3, K4, K1 and K2 so far."""
    from ctrl_sim_tpu_torch.ops import attention
    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    return (fa.flash_mha_fwd.launches, fa.flash_mha_bwd.launches, attention.cached_decode_attention.launches,
            attention.cached_decode_attention_q8.launches)


def _zero_counts() -> None:
    import torch

    from ctrl_sim_tpu_torch.ops import attention
    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    fa.flash_mha_fwd.launches = fa.flash_mha_bwd.launches = 0
    attention.cached_decode_attention.launches = attention.cached_decode_attention_q8.launches = 0


def _expect_counts(phase: str, expected: tuple[int, int, int, int]) -> None:
    got = _counts()
    if got != expected:
        raise AssertionError(f"{phase}: (K3, K4, K1, K2) launched {got} times on the main path, expected {expected}")


def _check_metrics(phase: str, metrics: dict, rates: tuple[str, ...]) -> None:
    """Every metric finite, rates in [0, 1], JSDs in [0, sqrt(ln 2)]."""
    if not metrics:
        raise AssertionError(f"{phase}: no metrics (no scene had a vehicle to evaluate)")
    for k, v in metrics.items():
        ok = math.isfinite(v)
        if k in rates:
            ok = ok and 0.0 <= v <= 1.0
        if k.endswith("_jsd"):
            ok = ok and 0.0 <= v <= math.sqrt(math.log(2)) + 1e-12
        if not ok:
            raise AssertionError(f"{phase}: metric {k} = {v} out of its range")


POLICY_RATES = ("goal", "collision_rate", "offroad_rate")
PLANNER_RATES = ("ego_goal", "ego_cr", "ego_cr_w_adv", "ego_or")


def _flash_eval_shape(gen, B: int) -> dict:
    """K3 at the exact rollout's decode shape (B lanes, T = 32 x 24 x 3,
    H = 256 = 8 x 32, bf16, dropout 0, forward only) against the plain
    version, timed beside its bound and SDPA; and a launch through
    ``flash_mha`` under ``torch.inference_mode`` leaves nothing allocated
    but its output. The plain version materializes [B, 8, T, T] fp32
    scores, so it runs on ``PLAIN_LANES`` lanes at a time (its time is that
    of all the slices)."""
    import torch
    import torch.nn.functional as F

    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    spec, heads, d = fa.MaskSpec(24, 3, 0, False, None), 8, 32
    q, k, v, _ = _flash_inputs(B, 32, 24, 3, heads, d, torch.bfloat16, gen)
    T = q.shape[1]
    with torch.inference_mode():
        out, lse = fa.flash_mha_fwd(q, k, v, spec, heads)
        slices = [slice(i, i + PLAIN_LANES) for i in range(0, B, PLAIN_LANES)]
        err = 0.0
        for b in slices:
            want, want_lse = fa.flash_mha_reference(q[b], k[b], v[b], spec, heads)
            err = max(err, (out[b].float() - want.float()).abs().max().item(),
                      (lse[b] - want_lse).abs().max().item())
            del want, want_lse
        torch.cuda.empty_cache()
        if not torch.isfinite(out.float()).all() or err > TOL["bfloat16"]:
            raise AssertionError(f"K3 at B={B} T={T} disagrees with its plain version: {err}")
        before = torch.cuda.memory_allocated()
        kept = fa.flash_mha(q, k, v, spec, heads)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        if held >= kept.numel() * kept.element_size() + lse.numel() * lse.element_size():
            raise AssertionError(f"K3 under inference_mode left {held} bytes allocated, its output is "
                                 f"{kept.numel() * kept.element_size()}: something was kept for a backward")
        del kept
        ms = _median_ms(lambda: fa.flash_mha_fwd(q, k, v, spec, heads))
        plain_ms = _median_ms(lambda: [fa.flash_mha_reference(q[b], k[b], v[b], spec, heads) for b in slices],
                              reps=3, warmup=1, batch=1)
        idx = torch.arange(T, device="cuda")
        mask = fa.block_mask(idx[:, None], idx[None, :], T, spec)
        q4, k4, v4 = (x.view(B, T, heads, d).transpose(1, 2) for x in (q, k, v))
        library_ms = _median_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask),
                                reps=10, warmup=2)
    bound, by = _flash_bounds(B, T, heads * d, heads, spec, "bfloat16")["fwd"]
    del q, k, v, out, lse, mask, q4, k4, v4
    torch.cuda.empty_cache()
    return {"shape": f"B={B} T={T} H=256/8 bf16 dropout 0, forward only", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
            "inference_mode_bytes_held": held}


def _eval_exact() -> dict:
    """``PolicyEvaluator.evaluate`` in multi_agent mode, exact rollout, at
    full width on one chunk of 32 scenes (``rollout/setup.py``): K3
    launched 2 passes x 4 layers x 90 steps = 720 times, K4, K1 and K2
    never; the tile table built once for the 720 launches; every metric in
    its range."""
    import torch

    from ctrl_sim_tpu_torch.evals.evaluator import PolicyEvaluator
    from ctrl_sim_tpu_torch.ops import flash_attention as fa
    from ctrl_sim_tpu_torch.rollout.setup import exact_eval_setup

    cfg, model, scenes = exact_eval_setup(SEED)
    ev = PolicyEvaluator(cfg, model, lane_batch=32)
    (_, controlled, groups), = ev.chunks(scenes)
    E, G = controlled.shape[0], groups.num_groups
    per_scene = collections.Counter(groups.group_valid.sum(dim=1).tolist())
    tables0 = fa._device_tile_table.cache_info()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    start = time.perf_counter()
    metrics = ev.evaluate(scenes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    per_chunk = 2 * cfg.model.num_decoder_layers * cfg.sim.steps
    _expect_counts("eval-exact", (per_chunk, 0, 0, 0))
    tables1 = fa._device_tile_table.cache_info()
    built, reused = tables1.misses - tables0.misses, tables1.hits - tables0.hits
    if built > 1 or built + reused != per_chunk:
        raise AssertionError(f"eval-exact: the tile table was built {built} times and reused {reused} times "
                             f"over {per_chunk} launches")
    _check_metrics("eval-exact", metrics, POLICY_RATES)
    return {"wall_s": wall, "launches": per_chunk, "E": E, "G": G, "EG": E * G, "metrics": metrics,
            "groups_per_scene": ", ".join(f"{g}: {n} scenes" for g, n in sorted(per_scene.items())),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "tables_built": built,
            "evaluated": int(controlled.sum()), "cfg": cfg, "model": model, "scenes": scenes}


def _eval_multigroup(cfg, model) -> tuple[int, str]:
    """8 scenes of 40 agents at full width, in two or more focal groups a
    scene: the chunk's exact rollout, then the same chunk padded by one
    empty group under the first run's draws, whose metrics must be equal
    and whose logits must agree within the bf16 tolerance of the
    replayed-draw tests (0.05). Returns (G, detail)."""
    import torch

    from ctrl_sim_tpu_torch.config import _set_dotted
    from ctrl_sim_tpu_torch.evals.evaluator import PolicyEvaluator
    from ctrl_sim_tpu_torch.evals.metrics import PolicyMetricsAccumulator
    from ctrl_sim_tpu_torch.rollout.groups import pad_groups
    from ctrl_sim_tpu_torch.rollout.policy import PolicySampler
    from ctrl_sim_tpu_torch.rollout.setup import eval_scenes

    cfg = _set_dotted(cfg, "sim.max_agents", 40)
    ev = PolicyEvaluator(cfg, model)
    (batch, controlled, groups), = ev.chunks(eval_scenes(cfg, lanes=8, agents=40))
    G = groups.num_groups
    if G < 2:
        raise AssertionError(f"eval-multigroup: expected two or more focal groups, got {G}")
    per_chunk = 2 * cfg.model.num_decoder_layers * cfg.sim.steps
    recording = _RecordingSampler(PolicySampler(cfg, torch.Generator(device="cuda").manual_seed(SEED)))
    runs = []
    for spec, sampler in ((groups, recording), (pad_groups(groups, G + 1), None)):
        sampler = sampler or _ReplaySampler(recording.rtg, recording.act, "cuda")
        _zero_counts()
        start = time.perf_counter()
        out = ev.rollout(batch, controlled, spec, None, sampler)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        _expect_counts("eval-multigroup", (per_chunk, 0, 0, 0))
        acc = PolicyMetricsAccumulator(cfg)
        acc.update(out, batch)
        runs.append((acc.compute(), sampler.logits, elapsed))
    (m0, l0, s0), (m1, l1, s1) = runs
    _check_metrics("eval-multigroup", m0, POLICY_RATES)
    logit_err = max((a - b).abs().max().item() for a, b in zip(l0, l1))
    if m0 != m1 or logit_err > 0.05:
        raise AssertionError(f"eval-multigroup: the chunk padded to G + 1 differs: logits {logit_err}, "
                             f"metrics {m0} against {m1}")
    return G, (f"8 scenes of 40 agents, G = {G} (EG = {8 * G}), {int(controlled.sum())} vehicles evaluated; padded "
            f"to G = {G + 1}: metrics equal, max |d action logits| {logit_err:.3g}; {per_chunk} K3 launches each; "
            f"rollouts {s0:.3f} s and {s1:.3f} s (cold, not a benchmark); goal {m0['goal']:.4f}, ade "
            f"{m0['ade']:.4f}")


def _eval_streaming(cfg, model, scenes) -> str:
    """The eval-exact chunk through the streaming rollout (episode-start
    frames, 16 packed slots): K1 launched 720 times, no other kernel."""
    import torch

    from ctrl_sim_tpu_torch.config import _set_dotted
    from ctrl_sim_tpu_torch.evals.evaluator import PolicyEvaluator

    for key, value in {"eval.rollout_mode": "streaming", "waymo.episode_start_normalization": True,
                       "eval.agent_slots": 16}.items():
        cfg = _set_dotted(cfg, key, value)
    ev = PolicyEvaluator(cfg, model)
    _zero_counts()
    start = time.perf_counter()
    metrics = ev.evaluate(scenes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    per_chunk = 2 * cfg.model.num_decoder_layers * cfg.sim.steps
    _expect_counts("eval-streaming", (0, 0, per_chunk, 0))
    _check_metrics("eval-streaming", metrics, POLICY_RATES)
    return (f"{len(scenes)} scenes, 16 slots, {per_chunk} K1 launches, evaluate {wall:.3f} s (cold, not a "
            f"benchmark); goal {metrics['goal']:.4f}, collision {metrics['collision_rate']:.4f}, ade "
            f"{metrics['ade']:.4f}")


def _attack_path(scene, target: int, attacker: int):
    """A CAT-style attack: ``attacker`` drives straight from its start to
    where ``target`` is mid-episode, and on along the same line."""
    import numpy as np

    meet = scene.traj_position.shape[1] // 2
    p0 = scene.traj_position[attacker, 0].astype(np.float64)
    step = (scene.traj_position[target, meet] - p0) / meet
    return (p0[None] + np.arange(scene.traj_position.shape[1])[:, None] * step[None]).astype(np.float32)


def _eval_planner(cfg, model) -> str:
    """``PlannerAdversaryEvaluator`` on 8 scenes of 12 agents, exact
    rollout, per-agent tilts: ego and adversary are each scene's first
    conflict pair (agents 1 and 2, on crossing courses); the adversary of
    scene 0 replays a CAT attack path (``evals/cat.py``'s polyline yaw and
    speed), the others run the negatively tilted policy."""
    import torch

    from ctrl_sim_tpu_torch.evals.planner_adversary import PlannerAdversaryEvaluator
    from ctrl_sim_tpu_torch.rollout.setup import eval_scenes

    scenes = eval_scenes(cfg, lanes=8, conflict_pairs=2)
    advs = [_attack_path(scenes[0], target=1, attacker=2)] + [None] * 7
    ev = PlannerAdversaryEvaluator(cfg, model)
    _zero_counts()
    start = time.perf_counter()
    metrics = ev.evaluate(scenes, [(1, 2)] * len(scenes), advs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    per_chunk = 2 * cfg.model.num_decoder_layers * cfg.sim.steps
    _expect_counts("eval-planner", (per_chunk, 0, 0, 0))
    _check_metrics("eval-planner", metrics, PLANNER_RATES)
    return (f"{len(scenes)} scenes, one CAT replay, {per_chunk} K3 launches, evaluate {wall:.3f} s (cold, not a "
            f"benchmark); ego goal {metrics['ego_goal']:.4f}, ego cr {metrics['ego_cr']:.4f}, cr with adversary "
            f"{metrics['ego_cr_w_adv']:.4f}, ego ade {metrics['ego_ade']:.4f}")


def _finetune(store) -> str:
    """3 full-width train steps on a ``FinetuningStore`` that mixes the
    training phase's replayed store with 16 CAT scenes (agent 1 replaced by
    an attack on agent 2, replayed through physics): K3/K4 launched 16 times
    each a step, every loss finite."""
    import torch

    from ctrl_sim_tpu_torch.data import synthetic_scenario
    from ctrl_sim_tpu_torch.data.finetune import FinetuningStore
    from ctrl_sim_tpu_torch.data.store import ScenarioStore
    from ctrl_sim_tpu_torch.evals.cat import make_adversarial_scenario
    from ctrl_sim_tpu_torch.profile_train import AGENTS, ARENA, LANE_ROADS, full_width_setup

    cfg, store, state, train_step, data_gen, dropout_gen, _ = full_width_setup(SEED, store=store)
    cat_scenes = []
    for s in range(16):
        base = synthetic_scenario(cfg, seed=1000 + s, num_agents=AGENTS, arena_half=ARENA, num_lanes=LANE_ROADS,
                                  conflict_pairs=2)
        cat_scenes.append(make_adversarial_scenario(base, 1, _attack_path(base, target=2, attacker=1))[0])
    ft = FinetuningStore(cfg, store, ScenarioStore.from_scenes(cfg, cat_scenes), [1] * len(cat_scenes))
    per_step = cfg.model.num_decoder_layers * cfg.train.accum_steps
    losses_seen, step_ms = [], []
    for i in range(FAMILY_TRAIN_STEPS):
        batch = ft.sample_batch(data_gen, cfg.train.global_batch_size)
        _zero_counts()
        start = time.perf_counter()
        state, losses = train_step(state, batch, dropout_gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        _expect_counts(f"finetune step {i}", (per_step, per_step, 0, 0))
        values = [float(x) for x in losses] + [float(state.grad_norm)]
        if not all(map(math.isfinite, values)) or values[0] <= 0:
            raise AssertionError(f"finetune step {i}: non-finite or zero loss or gradient norm {values}")
        losses_seen.append(values[0])
    return (f"{FAMILY_TRAIN_STEPS} steps of {cfg.train.global_batch_size} = {cfg.waymo.replay_ratio:.0%} replayed + "
            f"CAT scenes centred on their adversary; losses {', '.join(f'{x:.4f}' for x in losses_seen)}; step ms "
            f"{', '.join(f'{x:.1f}' for x in step_ms)}; {per_step} K3 and {per_step} K4 launches a step")


def _flash_width_case(gen, d: int) -> dict:
    """K3/K4 at a head width with no kernel instance (the wrappers pad each
    head to the next one), at the train step's layout (B = 16, T = 2304, 8
    heads of width d, bf16, dropout 0.1): held against the plain version,
    then timed beside their bounds at the true width, the plain version
    (dropout 0.1) and SDPA (dropout 0), forward and backward."""
    import torch

    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    heads = 8
    q, k, v, do = _flash_inputs(16, 32, 24, 3, heads, d, torch.bfloat16, gen)
    spec, seed = fa.MaskSpec(24, 3, 0, False, None), torch.tensor([13], device="cuda")
    row = _flash_compare(q, k, v, do, spec, heads, 0.1, seed)
    out, lse = fa.flash_mha_fwd(q, k, v, spec, heads, 0.1, seed)
    row["fwd_ms"] = _median_ms(lambda: fa.flash_mha_fwd(q, k, v, spec, heads, 0.1, seed))
    row["bwd_ms"] = _median_ms(lambda: fa.flash_mha_bwd(q, k, v, out, do, lse, spec, heads, 0.1, seed))
    bounds = _flash_bounds(16, q.shape[1], heads * d, heads, spec, "bfloat16")
    (row["fwd_bound_ms"], row["fwd_bound_by"]), (row["bwd_bound_ms"], row["bwd_bound_by"]) = bounds["fwd"], bounds["bwd"]
    del out, lse
    row.update(_flash_plain_and_library_ms(q, k, v, do, spec, heads, 0.1, seed))
    del q, k, v, do
    torch.cuda.empty_cache()
    return row


ROOT = Path(__file__).resolve().parent
R05 = ROOT / "artifacts" / "torch" / "r05_s0"  # the trained checkpoint, converted for the port
R05_SEED0 = 1000  # the artifacts' held-out scene seeds (tools/make_r05_artifacts.py)
R05_TILTS = (-50.0, 0.0, 10.0)
R05_PLANNER = {  # the planner leg's relaxed "interesting pair" thresholds (tools/make_r05_artifacts.py)
    "eval.rollout_mode": "streaming", "eval.interesting_traj_len_threshold": 20,
    "eval.interesting_timestep_diff_threshold": 5, "eval.interesting_goal_dist_threshold": 1000.0,
}
TILT_SCENES, PLANNER_SCENES, JSON_SCENES = 256, 64, 64
# the JAX package's per-eval-seed planner readings on r05_s0 (tools/r05_planner_seed_spread.py)
PLANNER_JAX_SEEDS = ROOT / "artifacts" / "torch" / "eval_r05_planner_jax_seeds.json"


def _r05(device: str, **extra):
    """(cfg, model in eval mode, step) of the converted r05 checkpoint on
    ``device``: its ``config.json`` with ``extra`` overrides."""
    from ctrl_sim_tpu_torch.training.checkpoint import checkpoint_config, restore_model

    cfg = checkpoint_config(str(R05), extra)
    model, step = restore_model(cfg, str(R05), device)
    return cfg, model, step


def _r05_scenes(cfg, n: int, conflict_pairs: int) -> list:
    """The artifacts' held-out scenes: 8 agents from seed 1000."""
    from ctrl_sim_tpu_torch.data import synthetic_scenario

    return [synthetic_scenario(cfg, seed=R05_SEED0 + s, num_agents=8, conflict_pairs=conflict_pairs)
            for s in range(n)]


def _trained_weights(device: str = "cuda") -> str:
    """The r05 checkpoint restored on the card and on the CPU: the training
    forward's heads on the same batch of held-out scenes within 1e-4 (f32;
    on the card the self-attention is K3's f32 kernel, one launch a layer)."""
    import torch

    from ctrl_sim_tpu_torch.data.store import ScenarioStore

    cfg, card, step = _r05(device)
    _, cpu, _ = _r05("cpu")
    store = ScenarioStore.from_scenes(cfg, _r05_scenes(cfg, 8, 1), device="cpu")
    batch = store.sample_batch(torch.Generator().manual_seed(SEED), 8)
    with torch.no_grad():
        want = cpu(batch)
        _zero_counts()
        got = card({k: v.to(device) for k, v in batch.items()})
        torch.cuda.synchronize()
    _expect_counts("trained-weights", (cfg.model.num_decoder_layers, 0, 0, 0))
    errs = {h: (getattr(got, h).cpu() - getattr(want, h)).abs().max().item()
            for h in ("action_preds", "rtg_preds", "state_preds")}
    if not all(math.isfinite(e) and e <= 1e-4 for e in errs.values()):
        raise AssertionError(f"trained-weights: the card's heads differ from the CPU's: {errs}")
    return (f"{R05.relative_to(ROOT)} step {step}, f32, H = {cfg.model.hidden_dim}/{cfg.model.num_heads}, "
            f"8 held-out scenes; max |d| card vs CPU " + ", ".join(f"{h} {e:.3g}" for h, e in errs.items())
            + " (limit 1e-4)")


def _held(label: str, value: float, want: float, bound: float, art: str, misses: list) -> None:
    """One in-distribution check: |value - want| <= bound, printed."""
    ok = abs(value - want) <= bound
    print(f"  {label}: {value:.4f}, {art}, |d| {abs(value - want):.4f} <= bound {bound:.4f}: "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        misses.append(label)


def _seed_bound(key: str, s0: float, s1: float, n: int) -> float:
    """The tilt sweep's bound around the mean of the artifact's two seeds:
    the larger of 3 x |seed0 - seed1|, 3 binomial standard errors over the
    ``n`` controlled agents (rates), 5% of the mean (ADE)."""
    mean = (s0 + s1) / 2
    bound = 3 * abs(s0 - s1)
    if key == "ade":
        return max(bound, 0.05 * abs(mean))
    return max(bound, 3 * math.sqrt(mean * (1 - mean) / n))


def _tilt_sweep(device: str = "cuda", n_scenes: int = TILT_SCENES) -> dict:
    """The artifact's recipe on the port (``tools/make_r05_artifacts.py``
    leg ``tilt``, corpus ``veh_conflict``): r05_s0, ``n_scenes`` held-out
    scenes with one crossing pair, streaming, 32 lanes a chunk, veh-veh
    tilts -50, 0 and 10 at eval seed 0; K1 launched 2 passes x layers x
    steps a chunk; each metric held to the artifact's two seeds; ADE at
    -50 above ADE at 10."""
    import torch

    from ctrl_sim_tpu_torch.data.transforms import get_tilt_logits
    from ctrl_sim_tpu_torch.evals.evaluator import PolicyEvaluator

    cfg, model, _ = _r05(device, **{"eval.rollout_mode": "streaming", "eval.seed": 0})
    scenes = _r05_scenes(cfg, n_scenes, 1)
    ev = PolicyEvaluator(cfg, model, lane_batch=32, device=device)
    chunks = ev.chunks(scenes)
    n = sum(int(c.sum()) for _, c, _ in chunks)
    with open(ROOT / "artifacts" / "eval_r05_tilt_sweep.json") as f:
        art = json.load(f)["veh_conflict"]
    per_chunk = 2 * cfg.model.num_decoder_layers * cfg.sim.steps
    rows, walls, misses = {}, {}, []
    for tilt in R05_TILTS:
        ev.tilt_logits = get_tilt_logits(0.0, tilt, 0.0, cfg.waymo, device=device)
        _zero_counts()
        start = time.perf_counter()
        m = ev.evaluate(scenes)
        if device == "cuda":
            torch.cuda.synchronize()
            _expect_counts(f"tilt-sweep {tilt:g}", (0, 0, per_chunk * len(chunks), 0))
        walls[tilt] = time.perf_counter() - start
        rows[tilt] = m
        for key in ("goal", "collision_rate", "ade"):
            s0, s1 = art[f"seed0_tilt{int(tilt)}"][key], art[f"seed1_tilt{int(tilt)}"][key]
            _held(f"tilt {tilt:g} {key}", m[key], (s0 + s1) / 2, _seed_bound(key, s0, s1, n),
                  f"artifact {s0:.4f}/{s1:.4f}", misses)
    if not rows[-50.0]["ade"] > rows[10.0]["ade"]:
        misses.append(f"ADE at -50 ({rows[-50.0]['ade']:.4f}) not above ADE at 10 ({rows[10.0]['ade']:.4f})")
    if misses:
        raise AssertionError(f"tilt-sweep: out of the artifact's distribution: {misses}")
    return {"rows": rows, "walls": walls, "n": n, "chunks": len(chunks), "per_chunk": per_chunk,
            "cfg": cfg, "model": model, "scenes": scenes}


def _r05_decode_shape(cfg, model, scenes, gen) -> list[dict]:
    """K1 at r05's decode shape (a chunk of 32 lanes, f32, H = 64 = 4 x 16)
    under the masks its streaming rollout gives the two passes of the
    middle step, against its plain version, timed beside its bound. A
    kernel of f32 compute over an f32 cache: ``model.kv_cache_dtype`` other
    than int8 keeps the cache in the compute dtype."""
    from ctrl_sim_tpu_torch.data import stack_scenarios, to_torch
    from ctrl_sim_tpu_torch.rollout.setup import recorded_masks

    sc = to_torch(stack_scenarios(scenes[:2], cfg), "cuda")
    masks = recorded_masks(cfg, model, sc, sc.moving & sc.agent_valid)[cfg.sim.steps // 2]
    dtype = cfg.model.compute_dtype
    return [_attention_case(32, *m.shape, cfg.model.hidden_dim, cfg.model.num_heads, dtype, m, gen, graph=True)
            for m in masks]


def _mean_bound(key: str, jax_xs: list, card_xs: list, pairs: int) -> float:
    """The planner phase's bound on |card mean - JAX mean| over eval seeds:
    3 standard errors of a difference of two means, from the two packages'
    own spreads over their seeds; for the rate at least 3 binomial standard
    errors of that difference over the pairs each mean covers."""
    se2 = statistics.variance(jax_xs) / len(jax_xs) + statistics.variance(card_xs) / len(card_xs)
    if key == "ego_cr_w_adv":
        p = statistics.fmean(jax_xs)
        se2 = max(se2, p * (1 - p) * (1 / (len(jax_xs) * pairs) + 1 / (len(card_xs) * pairs)))
    return 3 * math.sqrt(se2)


def _planner_trained(device: str = "cuda", n_scenes: int = PLANNER_SCENES) -> dict:
    """The artifact's planner leg on the port: r05_s0, ``n_scenes`` held-out
    scenes with two crossing pairs, streaming, the relaxed pair thresholds,
    adversary veh-veh tilts -10 and -50, at each eval seed of
    ``PLANNER_JAX_SEEDS`` (the JAX package's readings at those seeds, made by
    ``tools/r05_planner_seed_spread.py``). The card's mean over the seeds of
    ``ego_cr_w_adv`` and ``adv_coll_speed`` is held to the JAX package's
    within ``_mean_bound``. ``artifacts/eval_r05_planner.json``, one run of
    the JAX package at eval seed 0, is printed beside it: one run is no
    yardstick for a mean."""
    import torch

    from ctrl_sim_tpu_torch.config import TiltConfig, _set_dotted
    from ctrl_sim_tpu_torch.evals.planner_adversary import PlannerAdversaryEvaluator, select_planner_adversary_pair

    cfg, model, _ = _r05(device, **R05_PLANNER)
    scenes = _r05_scenes(cfg, n_scenes, 2)
    pairs = sum(select_planner_adversary_pair(cfg, s) is not None for s in scenes)
    with open(PLANNER_JAX_SEEDS) as f:
        ref = json.load(f)
    with open(ROOT / "artifacts" / "eval_r05_planner.json") as f:
        art = json.load(f)
    seeds = ref["eval_seeds"]
    per_chunk = 2 * cfg.model.num_decoder_layers * cfg.sim.steps
    rows, misses = {}, []
    for name, tilt in (("reference_tilts", -10.0), ("strong_adversary", -50.0)):
        runs = []
        start = time.perf_counter()
        for seed in seeds:
            ev = PlannerAdversaryEvaluator(_set_dotted(cfg, "eval.seed", seed), model,
                                           adversary_tilt=TiltConfig(veh_veh_tilt=tilt), lane_batch=32, device=device)
            _zero_counts()
            runs.append(ev.evaluate(scenes))
            if device == "cuda":
                torch.cuda.synchronize()
                _expect_counts(f"planner-adversary-trained {tilt:g} seed {seed}",
                               (0, 0, per_chunk * -(-pairs // 32), 0))
        m = {k: statistics.fmean(r[k] for r in runs) for k in runs[0]}
        rows[name] = {**m, "wall_s": time.perf_counter() - start,
                      "per_seed": {k: [r[k] for r in runs] for k in ("ego_cr_w_adv", "adv_coll_speed")}}
        for key in ("ego_cr_w_adv", "adv_coll_speed"):
            card_xs, jax_xs = rows[name]["per_seed"][key], ref[name][key]
            print(f"  adversary tilt {tilt:g} {key} at eval seeds {', '.join(map(str, seeds))}: card "
                  + ", ".join(f"{x:.4f}" for x in card_xs) + "; JAX " + ", ".join(f"{x:.4f}" for x in jax_xs),
                  flush=True)
            want = statistics.fmean(jax_xs)
            _held(f"adversary tilt {tilt:g} {key} (mean of {len(seeds)} seeds)", m[key], want,
                  _mean_bound(key, jax_xs, card_xs, pairs), f"JAX mean {want:.4f}", misses)
            print(f"    {key}: one JAX run at eval seed 0 (artifacts/eval_r05_planner.json) {art[name][key]:.4f}; "
                  f"card seed 0 {card_xs[0]:.4f}; not held", flush=True)
    if misses:
        raise AssertionError(f"planner-adversary-trained: out of the JAX package's distribution: {misses}")
    return {"rows": rows, "pairs": pairs, "seeds": seeds}


def _examples() -> str:
    """The port's three examples as subprocesses on the card, each exit 0."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    done = []
    for script in ("torch_replay_rollout.py", "torch_tilt_control.py", "torch_adversarial_scenarios.py"):
        start = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / script)], capture_output=True, text=True,
                              timeout=600, env=env, cwd=str(ROOT))
        for line in proc.stdout.splitlines():
            print(f"  {script}: {line}", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"examples/{script} exited {proc.returncode}: {proc.stderr[-2000:]}")
        done.append(f"{script} {time.perf_counter() - start:.1f} s")
    return "exit 0: " + ", ".join(done)


def _cpu_model() -> str:
    """This machine's CPU model (``/proc/cpuinfo``, else ``lscpu``) and its
    core count, for the loaders' files/s."""
    import os

    name = ""
    try:
        with open("/proc/cpuinfo") as f:
            name = next((line.split(":", 1)[1].strip() for line in f if line.startswith("model name")), "")
    except OSError:
        pass
    if not name or name.lower() == "unknown":
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
            name = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                         if line.startswith("Model name")), name)
        except (OSError, subprocess.SubprocessError):
            pass
    return f"{name or 'an unnamed CPU'}, {os.cpu_count()} cores"


def _scenes_equal(a, b, tol: float) -> float:
    """Max float difference of two scenes' fields (headings modulo 2 pi);
    integers, masks and light states must be equal and are checked here."""
    import dataclasses

    import numpy as np

    worst = 0.0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not isinstance(x, np.ndarray) and not isinstance(y, np.ndarray):
            continue
        if x is None or y is None or x.shape != y.shape:
            raise AssertionError(f"json-data: the loaders disagree on {f.name}")
        if np.issubdtype(x.dtype, np.floating):
            diff = x.astype(np.float64) - y
            if f.name.endswith("heading"):  # a heading of pi may be parsed as -pi
                diff = (diff + np.pi) % (2 * np.pi) - np.pi
            worst = max(worst, float(np.abs(diff).max(initial=0.0)))
        elif not np.array_equal(x, y):
            raise AssertionError(f"json-data: the loaders disagree on {f.name}")
    if worst > tol:
        raise AssertionError(f"json-data: the loaders' floats differ by {worst} > {tol}")
    return worst


def _json_data(device: str = "cuda", n: int = JSON_SCENES, extra: dict | None = None) -> str:
    """``n`` scenes of the default config (12 agents, ``eval_sim``'s arena,
    one crossing pair) written in the raw dialect and, replayed on the card,
    in the physics dialect; read back by both loaders (files/s on this
    machine's CPU, fields held equal); ``train.py --data_dir --val_dir``
    for 3 full-width steps (16 K3 and 16 K4 a step, plus one validation
    forward of 4 K3); ``eval_sim.py --data_dir`` on 8 of them, streaming
    (K1) and exact (K3); and the focal groups the loaded scenes fall into.
    ``extra``: overrides of the config and of every CLI call (a smaller
    model for a rehearsal on the CPU)."""
    import random
    import tempfile

    import numpy as np
    import torch

    from ctrl_sim_tpu_torch import eval_sim, train
    from ctrl_sim_tpu_torch.config import _set_dotted, preset
    from ctrl_sim_tpu_torch.data import synthetic_scenario
    from ctrl_sim_tpu_torch.data.export import export_physics_json, export_raw_json
    from ctrl_sim_tpu_torch.data.store import ScenarioStore, load_json_dir
    from ctrl_sim_tpu_torch.evals.evaluator import select_vehicles_to_evaluate
    from ctrl_sim_tpu_torch.rollout.groups import build_focal_groups

    cfg = preset("ctrl_sim")
    for key, value in (extra or {}).items():
        cfg = _set_dotted(cfg, key, value)
    flags = [x for key, value in (extra or {}).items() for x in ("-o", f"{key}={json.dumps(value)}")]
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_json_"))
    raw_dir, val_dir, phys_dir = work / "raw", work / "val", work / "physics"
    for d in (raw_dir, val_dir, phys_dir):
        d.mkdir(parents=True, exist_ok=True)
    scenes = [synthetic_scenario(cfg, seed=s, num_agents=12, conflict_pairs=1) for s in range(n)]
    for i, scene in enumerate(scenes):
        export_raw_json(scene, str((raw_dir if i < n - 8 else val_dir) / f"scene_{i:04d}.json"))
    store = ScenarioStore.from_scenes(cfg, scenes, device=device)
    for e in range(n):
        export_physics_json(cfg, store.scenario, store.offline, e, str(phys_dir / f"scene_{e:04d}_physics.json"))
    del store

    from ctrl_sim_tpu_torch.data import native_loader

    start = time.perf_counter()
    native_loader.build()  # g++ at first use: kept out of the files/s
    lines = [f"{n} scenes a dialect on {_cpu_model()}; native loader built in {time.perf_counter() - start:.2f} s"]
    loaded = {}
    for dialect, dirs in (("raw", (raw_dir, val_dir)), ("physics", (phys_dir,))):
        rates = {}
        for native in (False, True):
            start = time.perf_counter()
            got = [s for d in dirs for s in load_json_dir(cfg, str(d), native=native)]
            rates[native] = len(got) / (time.perf_counter() - start)
            loaded[dialect, native] = got
        worst = max(_scenes_equal(a, b, 1e-5) for a, b in zip(loaded[dialect, False], loaded[dialect, True]))
        lines.append(f"{dialect}: Python loader {rates[False]:.1f} files/s, native {rates[True]:.1f} files/s, "
                     f"fields equal (floats within {worst:.3g})")

    per_step = cfg.model.num_decoder_layers * 4
    _zero_counts()
    start = time.perf_counter()
    train.main(["--data_dir", str(raw_dir), "--val_dir", str(val_dir), "--steps", "3", "--val_every", "3",
                "--log_every", "1", "--save_dir", str(work / "ckpt"), "--device", device,
                "-o", "train.accum_steps=4", *flags])
    torch.cuda.synchronize()
    _expect_counts("json-data train", (3 * per_step + cfg.model.num_decoder_layers, 3 * per_step, 0, 0))
    lines.append(f"train.py --data_dir ({n - 8} scenes) --val_dir (8) 3 steps + 1 validation in "
                 f"{time.perf_counter() - start:.1f} s, K3/K4 {_counts()[:2]}")

    per_chunk = 2 * cfg.model.num_decoder_layers * cfg.sim.steps
    for mode, over, expected in (
            ("streaming", ["-o", "eval.rollout_mode=streaming", "-o", "waymo.episode_start_normalization=true",
                           "-o", "eval.agent_slots=16"], (0, 0, per_chunk, 0)),
            ("exact", [], (per_chunk, 0, 0, 0))):
        _zero_counts()
        start = time.perf_counter()
        metrics = eval_sim.main(["--data_dir", str(val_dir), "--device", device, *over, *flags])
        torch.cuda.synchronize()
        _expect_counts(f"json-data eval_sim {mode}", expected)
        _check_metrics(f"json-data eval_sim {mode}", metrics, POLICY_RATES)
        lines.append(f"eval_sim.py --data_dir (8 scenes) {mode} {time.perf_counter() - start:.1f} s, goal "
                     f"{metrics['goal']:.4f}, ade {metrics['ade']:.4f}, (K3, K4, K1, K2) {_counts()}")

    rng, groups = random.Random(cfg.eval.seed), collections.Counter()
    for scene in loaded["raw", False]:
        controlled = np.zeros((1, scene.traj_position.shape[0]), dtype=bool)
        controlled[0, select_vehicles_to_evaluate(cfg, scene, rng)] = True
        spec = build_focal_groups(cfg, scene.traj_position[None], scene.traj_valid[None], scene.agent_valid[None],
                                  controlled, device="cpu")
        groups[int(spec.group_valid.sum())] += 1
    lines.append("focal groups a loaded scene (multi_agent mode): "
                 + ", ".join(f"{k}: {v} scenes" for k, v in sorted(groups.items())))
    shutil.rmtree(work, ignore_errors=True)
    return "; ".join(lines)



def _rollout(phase: str, cfg, model, sc, controlled, tilt) -> tuple[float, int, str]:
    """One full-width ``run_streaming`` chunk on the card, the decode
    kernels' counts set to 0 just before it and read just after: its cache's
    kernel must launch once per pass, layer and step, the other never, and
    every output must be finite. Returns (seconds, launches, kernel name)."""
    import torch

    from ctrl_sim_tpu_torch.ops import attention
    from ctrl_sim_tpu_torch.rollout.setup import LANES
    from ctrl_sim_tpu_torch.rollout.streaming import run_streaming

    int8 = cfg.model.kv_cache_dtype == "int8"
    kernel = attention.cached_decode_attention_q8 if int8 else attention.cached_decode_attention
    _zero_counts()
    start = time.perf_counter()
    out = run_streaming(cfg, model, sc, controlled, torch.Generator(device="cuda").manual_seed(SEED), tilt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    steps = cfg.sim.steps
    launched = _decode_passes(cfg) * cfg.model.num_decoder_layers * steps
    _expect_counts(phase, (0, 0, 0, launched) if int8 else (0, 0, launched, 0))
    for name, x in out._asdict().items():
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"{phase}: non-finite rollout output {name}")
    if out.position.shape != (steps + 1, LANES, sc.traj_position.shape[1], 2):
        raise AssertionError(f"{phase}: unexpected position shape {tuple(out.position.shape)}")
    return elapsed, launched, kernel.__name__


def _decode_passes(cfg) -> int:
    """Decoder passes per env step that ``rollout/streaming.py`` should
    make, the expectation the launch counts are held to: the default
    family's fused decode takes 2 (3 when sequential), DT, IL and
    trajeglish 1."""
    mc = cfg.model
    if mc.decision_transformer or mc.il or mc.trajeglish:
        return 1
    return 3 if cfg.eval.streaming_passes >= 3 else 2


def _trained_phases(gen) -> list[dict]:
    """The phases on the trained r05 checkpoint and on scene JSONs:
    trained-weights, tilt-sweep, planner-adversary-trained, examples,
    json-data. Returns K1's rows at r05's decode shape."""
    t0 = time.perf_counter()
    _phase("trained-weights", t0, _trained_weights())

    t0 = time.perf_counter()
    sweep = _tilt_sweep()
    r05_k1 = _r05_decode_shape(sweep["cfg"], sweep["model"], sweep["scenes"], gen)
    for row in r05_k1:
        print(f"  K1 at r05's decode shape (f32 kernel, decode_attention_kernel<16>), {row['shape']}: err "
              f"{row['max_abs_err']:.3g}, kernel {row['ms']:.4f} ms (raw launch in a CUDA graph; eager wrapper "
              f"{row['wrapper_ms']:.4f} ms), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), plain "
              f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms (in a CUDA graph)", flush=True)
    rows = sweep["rows"]
    _phase("tilt-sweep", t0,
           f"r05_s0, {TILT_SCENES} held-out scenes (seed {R05_SEED0}, one crossing pair), {sweep['n']} controlled "
           f"agents in {sweep['chunks']} chunks of 32, streaming; " + "; ".join(
               f"tilt {t:g}: goal {m['goal']:.4f}, collision {m['collision_rate']:.4f}, ade {m['ade']:.4f}, "
               f"{sweep['walls'][t]:.2f} s" for t, m in rows.items())
           + f"; K1 {sweep['per_chunk']} launches a chunk; every metric within its bound of the artifact")

    t0 = time.perf_counter()
    planner = _planner_trained()
    _phase("planner-adversary-trained", t0,
           f"r05_s0, {PLANNER_SCENES} held-out scenes with two crossing pairs, {planner['pairs']} (ego, adversary) "
           f"pairs, streaming, means over eval seeds {planner['seeds']}; " + "; ".join(
               f"{name}: ego_cr_w_adv {m['ego_cr_w_adv']:.4f}, adv_coll_speed {m['adv_coll_speed']:.4f}, "
               f"ego_goal {m['ego_goal']:.4f}, {m['wall_s']:.2f} s" for name, m in planner["rows"].items())
           + "; within the bounds of the JAX package's means")

    t0 = time.perf_counter()
    _phase("examples", t0, _examples())

    t0 = time.perf_counter()
    _phase("json-data", t0, _json_data())
    return r05_k1


# ---------------------------------------------------------------------------
# CTG++ (section 12 of the docstring): no kernel of K1-K4 on its path
# ---------------------------------------------------------------------------

CTG_FULL_GOLDEN = GOLDEN.with_name("reference_ctg_full.npz")
CTG_GOLDEN = GOLDEN.with_name("reference_ctg.npz")
CTG_EVAL_SCENES, CTG_TRAIN_SCENES, CTG_TRAIN_STEPS = 32, 64, 5
CTG_TOY = {  # tests/torch_port_common.py's CTG++ toy: the executed reference's small golden's shapes
    "model.hidden_dim": 32, "model.num_heads": 2, "model.dim_feedforward": 64,
    "model.num_transformer_encoder_layers": 2, "model.n_diffusion_steps": 20, "model.n_eval_diffusion_step": 10,
    "model.use_rtg": False, "waymo.train_context_length": 6, "waymo.input_horizon": 3, "waymo.max_num_agents": 4,
    "waymo.rtg_discretization": 20, "waymo.max_num_road_polylines": 5, "waymo.max_num_road_pts_per_polyline": 6,
    "sim.max_agents": 4,
}
NO_LAUNCHES = (0, 0, 0, 0)


def _ctg_config(extra: dict):
    from ctrl_sim_tpu_torch.config import _set_dotted, preset

    cfg = preset("ctg_plus_plus")
    for key, value in extra.items():
        cfg = _set_dotted(cfg, key, value)
    return cfg


def _allclose_excess(got, want, atol: float, rtol: float) -> float:
    """How far |got - want| exceeds atol + rtol |want| at worst (<= 0: within)."""
    return ((got.float() - want).abs() - atol - rtol * want.abs()).max().item()


def _ctg_golden_cond(g: dict) -> dict:
    """A CTG++ golden's conditioning on the card, in the models' layout (the
    reference's per-agent timesteps [B, N, T, 1] hold one value: [B, T])."""
    import torch

    names = ("agent_past_states", "agent_past_actions", "agent_types", "goals", "rtgs", "road_points",
             "road_types")
    cond = {name: g[f"in_{name}"] for name in names}
    cond.update(past_relative_encodings=g["in_agent_past_rel_encodings"],
                future_relative_encodings=g["in_agent_future_rel_encodings"],
                moving_agent_mask=g["in_moving_agent_masks"], timesteps=g["in_timesteps"][:, 0, :, 0])
    return {k: torch.as_tensor(v, device="cuda") for k, v in cond.items()}


def _ctg_golden_full() -> str:
    """The DiT at the preset's full width (hidden 256, 8 heads, FF 1024, 2
    trunk layers, 24 agents, horizon 10 + 22, 200 x 100 road crops, RTG
    conditioning) in f32 on the card, with the executed reference's
    f16-snapped weights and inputs (``tests/goldens/reference_ctg_full.npz``)
    through the port's importer, against its output within 5e-4 + 1e-4 |ref|."""
    import numpy as np
    import torch

    from ctrl_sim_tpu_torch.models.ctg.dit import DiT
    from ctrl_sim_tpu_torch.params import from_flax_params
    from ctrl_sim_tpu_torch.utils.torch_import import ctg_params_from_torch_state

    with np.load(CTG_FULL_GOLDEN) as f:
        g = {k: f[k].astype(np.float32) if f[k].dtype == np.float16 else f[k] for k in f.files}
    cfg = _ctg_config({"model.use_rtg": True, "model.compute_dtype": "float32"})
    state = {"diff_model.model." + k[len("dit_w_"):]: v for k, v in g.items() if k.startswith("dit_w_")}
    weights = from_flax_params(ctg_params_from_torch_state(state, cfg))  # the denoiser alone: no RTG head here
    model = DiT(cfg, torch.float32, "cuda")
    model.load_state_dict({k.removeprefix("diffusion.model."): v for k, v in weights.items()}, strict=True)
    cond = _ctg_golden_cond(g)
    want = torch.as_tensor(g["dit_out"], device="cuda")
    _zero_counts()
    with torch.no_grad():
        out = model.eval()(torch.as_tensor(g["in_future_k"], device="cuda"), cond,
                           torch.as_tensor(g["in_diff_step"], device="cuda"))
    torch.cuda.synchronize()
    _expect_counts("ctg-golden-full", NO_LAUNCHES)
    err, excess = (out - want).abs().max().item(), _allclose_excess(out, want, 5e-4, 1e-4)
    if not torch.isfinite(out).all() or excess > 0:
        raise AssertionError(f"ctg-golden-full: max |d| {err} beyond 5e-4 + 1e-4 |ref| by {excess}")
    return (f"DiT {tuple(out.shape)} f32, reference weights through the port's importer: max |d| {err:.3g} "
            f"(within 5e-4 + 1e-4 |ref|); K1-K4 launches 0")


def _ctg_small_agreement() -> str:
    """The toy CTGPlusPlus (seeded weights) on the card against the same
    model on the CPU, on one CTG++ batch of synthetic scenes and the same
    draws: the DiT forward, the loss (dropout 0, the diffusion steps and
    noise given), an unguided and a guided sample (one noise stream), in
    f32 within 1e-4, and the forward and the loss in bf16 within 2e-2 (the
    absolute error over max(1, |ref|)). The bf16 samples, whose 10
    denoiser steps compound the rounding of each, are printed and not held,
    with the CPU's own bf16 error against its f32 samples beside them: the
    f32 samples hold the sampler."""
    import torch

    from ctrl_sim_tpu_torch.data import synthetic_scenario
    from ctrl_sim_tpu_torch.data.store import ScenarioStore
    from ctrl_sim_tpu_torch.models.ctg import guidance
    from ctrl_sim_tpu_torch.training import CTGTrainer

    rows, cpu_f32 = [], None
    for dtype in ("float32", "bfloat16"):
        cfg = _ctg_config({**CTG_TOY, "model.compute_dtype": dtype, "model.dropout": 0.0,
                           "model.goal_dropout": 0.0, "sim.steps": 16, "sim.resolve_contacts": False})
        scenes = [synthetic_scenario(cfg, seed=SEED + s, num_agents=4, arena_half=60.0, num_lanes=2)
                  for s in range(3)]
        store = ScenarioStore.from_scenes(cfg, scenes, device="cpu")
        batch = store.sample_batch(torch.Generator().manual_seed(SEED), 4, family="ctg_plus_plus")
        gen = torch.Generator().manual_seed(SEED)
        wc = cfg.waymo
        shape = (4, wc.max_num_agents, wc.train_context_length - wc.input_horizon, 7)
        draws = (torch.randint(0, cfg.model.n_diffusion_steps, (4,), generator=gen), torch.randn(shape, generator=gen))
        noise = (torch.randn(shape, generator=gen), torch.randn((cfg.model.n_eval_diffusion_step,) + shape,
                                                               generator=gen))
        cpu = CTGTrainer(cfg, device="cpu").init_state(torch.Generator().manual_seed(SEED)).model.eval()
        outs = {}
        for device, model in (("cpu", cpu), ("cuda", CTGTrainer(cfg, device="cuda").new_model())):
            if device == "cuda":
                model.load_state_dict(cpu.state_dict())
                model.eval()
            b = {k: v.to(device) for k, v in batch.items()}
            cond = {k: b[k] for k in ("agent_past_states", "agent_past_actions", "past_relative_encodings",
                                      "future_relative_encodings", "agent_types", "goals", "timesteps", "rtgs",
                                      "road_points", "road_types", "moving_agent_mask")}
            nz = tuple(x.to(device) for x in noise)
            guide = guidance.combine(guidance.goal_guide(1.0),
                                     guidance.collision_guide(b["anchor"], wc.pos_div, radius=4.0))
            _zero_counts()
            with torch.no_grad():
                outs[device] = {
                    "forward": model.diffusion.model(draws[1].to(device), cond, draws[0].to(device)),
                    "loss": model.loss(b, draws=tuple(x.to(device) for x in draws)).total,
                    "sample": model.sample_from_cond(cond, noise_override=nz),
                    "guided": model.sample_from_cond(cond, guidance_fn=guide, noise_override=nz),
                }
            if device == "cuda":
                torch.cuda.synchronize()
                _expect_counts(f"ctg-small-agreement {dtype}", NO_LAUNCHES)
        errs, tols = {}, {}

        def rel(a, b) -> float:
            return ((a.float() - b.float()).abs() / b.float().abs().clamp(min=1.0)).max().item()

        for name, want in outs["cpu"].items():
            got = outs["cuda"][name].float().cpu()
            if not torch.isfinite(got).all():
                raise AssertionError(f"ctg-small-agreement {dtype} {name}: non-finite on the card")
            errs[name] = rel(got, want)
            tols[name] = None if dtype == "bfloat16" and name in ("sample", "guided") else TOL[dtype]
            if tols[name] is not None and errs[name] > tols[name]:
                raise AssertionError(f"ctg-small-agreement {dtype} {name}: card vs CPU {errs[name]} (tol {tols[name]})")
        row = f"{dtype}: " + ", ".join(f"{k} {v:.3g} ({'not held' if tols[k] is None else f'tol {tols[k]}'})"
                                       for k, v in errs.items())
        if cpu_f32 is None:
            cpu_f32 = outs["cpu"]
        else:
            row += "; the CPU's bf16 against its f32: " + ", ".join(
                f"{k} {rel(outs['cpu'][k], cpu_f32[k]):.3g}" for k in ("forward", "sample", "guided"))
        rows.append(row)
    return "; ".join(rows) + "; K1-K4 launches 0"


class _Timed:
    """Times each call of a method (``cls.name``) between two
    synchronizations while the context is open, and keeps the first
    call's arguments; with ``profiled``, the first call runs under
    torch.profiler (``self.prof``), the profiler opened and closed inside
    the timed span."""

    def __init__(self, cls, name: str, profiled: bool = False):
        self.cls, self.name, self.orig, self.ms, self.first = cls, name, getattr(cls, name), [], None
        self.profiled, self.prof = profiled, None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        def timed(obj, *args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            if self.profiled and self.prof is None:
                with profile(activities=[ProfilerActivity.CUDA]) as self.prof:
                    out = self.orig(obj, *args, **kwargs)
                    torch.cuda.synchronize()
            else:
                out = self.orig(obj, *args, **kwargs)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - start) * 1e3)
            if self.first is None:
                self.first = (obj, args, kwargs)
            return out

        setattr(self.cls, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)


def _top_kernels(by_name: dict, total: float, n: int = 12) -> list[str]:
    return [f"    {ms:9.3f} ms {100 * ms / total:5.1f}%  {name[:100]}"
            for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def _ctg_eval() -> str:
    """``eval_sim --preset ctg_plus_plus --synthetic 32`` at full width with
    seeded weights (bf16, contacts on, 90 steps, 17 replans of 50 denoiser
    calls each): every metric finite and in range, K1-K4 never launched;
    its wall, time per replan and peak memory; then the same evaluation
    with ``PolicyEvaluator.evaluate`` alone under torch.profiler, its
    device time over the unprofiled ``evaluate`` wall the device's busy
    share (as ``profile_rollout`` takes it), and one replan profiled
    alone, its device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ctrl_sim_tpu_torch import eval_sim
    from ctrl_sim_tpu_torch.evals.evaluator import PolicyEvaluator
    from ctrl_sim_tpu_torch.models.ctg_plus_plus import CTGPlusPlus
    from ctrl_sim_tpu_torch.profile_rollout import _device_ms_by_kernel

    args = ["--preset", "ctg_plus_plus", "--synthetic", str(CTG_EVAL_SCENES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with _Timed(CTGPlusPlus, "sample_from_cond") as replans, _Timed(PolicyEvaluator, "evaluate") as evaluate:
        start = time.perf_counter()
        metrics = eval_sim.main(args)
        torch.cuda.synchronize()
        cli = time.perf_counter() - start
    _expect_counts("ctg-eval", NO_LAUNCHES)
    _check_metrics("ctg-eval", metrics, POLICY_RATES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(replans.ms) != 17:
        raise AssertionError(f"ctg-eval: {len(replans.ms)} replans, expected 17 (steps 9, 14, ..., 89)")
    wall = evaluate.ms[0] / 1e3
    with _Timed(PolicyEvaluator, "evaluate", profiled=True) as profiled:
        eval_sim.main(args)
    busy = sum(_device_ms_by_kernel(profiled.prof).values()) / 1e3
    model, (cond, *rest), kwargs = replans.first
    with profile(activities=[ProfilerActivity.CUDA]) as prof, torch.no_grad():
        model.sample_from_cond(cond, torch.Generator(device="cuda").manual_seed(SEED),
                               guidance_fn=kwargs.get("guidance_fn"))
        torch.cuda.synchronize()
    by_name = _device_ms_by_kernel(prof)
    replan_busy = sum(by_name.values())
    print(f"  one replan ({cond['agent_past_states'].shape[0]} scenes, 50 denoiser calls), device time by kernel:")
    print("\n".join(_top_kernels(by_name, replan_busy)), flush=True)
    steady = statistics.median(replans.ms[1:])
    return (f"{CTG_EVAL_SCENES} scenes x 90 steps, contacts on, bf16; PolicyEvaluator.evaluate wall {wall:.3f} s "
            f"(the CLI {cli:.3f} s with scene generation and the seeded init); evaluate's device busy {busy:.3f} s = "
            f"{100 * busy / wall:.1f}% of the unprofiled evaluate wall; "
            f"replans {len(replans.ms)}, first {replans.ms[0]:.1f} ms, steady median {steady:.1f} ms, all "
            f"{sum(replans.ms) / 1e3:.3f} s; one replan's device time {replan_busy:.1f} ms; peak memory "
            f"{peak:.2f} GiB; K1-K4 launches 0; goal {metrics['goal']:.4f}, collision "
            f"{metrics['collision_rate']:.4f}, offroad {metrics['offroad_rate']:.4f}, ade {metrics['ade']:.4f}, fde "
            f"{metrics['fde']:.4f} (random weights; one cold run on this card, not a benchmark)")


def _ctg_train() -> str:
    """``train.py --preset ctg_plus_plus`` at full width for 5 steps on 64
    synthetic scenes (global batch 64 as 2 x 32, dropout 0.1): every loss
    finite, K1-K4 never launched; the steady ms per step and the peak
    memory; then one step of the same trainer profiled, its device time by
    kernel."""
    import json as _json
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ctrl_sim_tpu_torch import train
    from ctrl_sim_tpu_torch.data import synthetic_scenario
    from ctrl_sim_tpu_torch.data.store import ScenarioStore
    from ctrl_sim_tpu_torch.profile_rollout import _device_ms_by_kernel
    from ctrl_sim_tpu_torch.training import CTGTrainer

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ctg_"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        train.main(["--preset", "ctg_plus_plus", "--synthetic", str(CTG_TRAIN_SCENES), "--steps",
                    str(CTG_TRAIN_STEPS), "--log_every", "1", "--save_dir", str(work / "ckpt")])
        torch.cuda.synchronize()
        _expect_counts("ctg-train", NO_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows = [_json.loads(r) for r in (work / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if len(rows) != CTG_TRAIN_STEPS or not all(math.isfinite(r[k]) for r in rows for k in
                                               ("total", "diffusion_loss", "a0_loss")):
        raise AssertionError(f"ctg-train: expected {CTG_TRAIN_STEPS} finite loss rows, got {rows}")
    step_ms = [1e3 / r["steps_per_sec"] for r in rows]

    cfg = _ctg_config({})
    scenes = [synthetic_scenario(cfg, seed=s, num_agents=12) for s in range(8)]
    store = ScenarioStore.from_scenes(cfg, scenes)
    trainer = CTGTrainer(cfg)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    step = trainer.make_train_step()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = store.sample_batch(gen, cfg.train.global_batch_size, family="ctg_plus_plus")
    state, _ = step(state, batch, gen)  # warm-up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    by_name = _device_ms_by_kernel(prof)
    busy = sum(by_name.values())
    print(f"  one train step (global batch {cfg.train.global_batch_size} = {cfg.train.accum_steps} x "
          f"{cfg.train.global_batch_size // cfg.train.accum_steps}), device time by kernel:")
    print("\n".join(_top_kernels(by_name, busy)), flush=True)
    del state, trainer, store
    torch.cuda.empty_cache()
    return (f"{CTG_TRAIN_STEPS} steps of global batch {cfg.train.global_batch_size} = {cfg.train.accum_steps} x "
            f"{cfg.train.global_batch_size // cfg.train.accum_steps}, {CTG_TRAIN_SCENES} scenes; loss "
            f"{rows[0]['total']:.4f} -> {rows[-1]['total']:.4f}; ms per step (the CLI's loop: batch build, "
            f"step, logging) {', '.join(f'{x:.1f}' for x in step_ms)}, steady median "
            f"{statistics.median(step_ms[1:]):.1f}; one step's device time {busy:.1f} ms; peak memory {peak:.2f} "
            f"GiB; K1-K4 launches 0 (one run on this card, not a benchmark)")


def _ctg_import() -> str:
    """The reference-layout import CLI on the executed reference's small
    CTG++ weights (``tests/goldens/reference_ctg.npz``, written as a
    Lightning file), the checkpoint restored on the card: its denoiser's
    and RTG head's outputs against the reference's within 2e-4 + 1e-4 |ref|."""
    import json as _json
    import tempfile

    import numpy as np
    import torch

    from ctrl_sim_tpu_torch import import_checkpoint
    from ctrl_sim_tpu_torch.training.checkpoint import restore_model

    with np.load(CTG_GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    state = {"diff_model.model." + k[len("dit_w_"):]: torch.tensor(v) for k, v in g.items() if k.startswith("dit_w_")}
    state.update({"rtg_model." + k[len("rtg_w_"):]: torch.tensor(v) for k, v in g.items() if k.startswith("rtg_w_")})
    over = {**CTG_TOY, "model.use_rtg": True, "model.compute_dtype": "float32"}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ctg_import_"))
    try:
        path = work / "ctg.ckpt"
        torch.save({"state_dict": state}, path)
        flags = [x for k, v in over.items() for x in ("-o", f"{k}={_json.dumps(v)}")]
        import_checkpoint.main(["--torch", str(path), "--out", str(work / "out"), "--preset", "ctg_plus_plus",
                                *flags])
        model, step = restore_model(_ctg_config(over), str(work / "out"), "cuda")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cond = _ctg_golden_cond(g)
    _zero_counts()
    with torch.no_grad():
        dit = model.diffusion.model(torch.as_tensor(g["in_future_k"], device="cuda"), cond,
                                    torch.as_tensor(g["in_diff_step"], device="cuda"))
        rtg = model.rtg_model(cond)
    torch.cuda.synchronize()
    _expect_counts("ctg-import", NO_LAUNCHES)
    errs = {}
    for name, got in (("dit_out", dit), ("rtg_out", rtg)):
        want = torch.as_tensor(g[name], device="cuda")
        errs[name] = (got - want).abs().max().item()
        if _allclose_excess(got, want, 2e-4, 1e-4) > 0:
            raise AssertionError(f"ctg-import: {name} off the reference by {errs[name]} (tol 2e-4 + 1e-4 |ref|)")
    return (f"restored step {step} on the card; max |d| dit_out {errs['dit_out']:.3g}, rtg_out "
            f"{errs['rtg_out']:.3g} (within 2e-4 + 1e-4 |ref|); K1-K4 launches 0")


def _ctg_phases() -> None:
    import torch

    torch.cuda.empty_cache()
    for name, fn in (("ctg-golden-full", _ctg_golden_full), ("ctg-small-agreement", _ctg_small_agreement),
                     ("ctg-eval", _ctg_eval), ("ctg-train", _ctg_train), ("ctg-import", _ctg_import)):
        t0 = time.perf_counter()
        _phase(name, t0, fn())
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ctrl_sim_tpu_torch.ops import attention, build
        from ctrl_sim_tpu_torch.ops import flash_attention as fa
        from ctrl_sim_tpu_torch.ops.heads import KERNEL_HEAD_DIMS, kernel_head_dim
        from ctrl_sim_tpu_torch.ops.masks import stream_step_masks
        from ctrl_sim_tpu_torch.rollout.setup import FAMILY_CASES, LANES, SLOTS, decode_masks, full_width_rollout
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
        for kernel, line in _ptxas_lines(report):
            print(f"  {source}: {kernel}: {line}")
    build_s = time.perf_counter() - t0
    bare = []
    for source, names in MMA_KERNELS.items():
        hmma = _hmma_counts(build.library_path(source))
        for kernel, count in sorted(hmma.items()):
            print(f"  {source}: {kernel}: {count} HMMA")
        for name in names:
            for d in KERNEL_HEAD_DIMS:  # every instance of the head width (and of the row tiles)
                counts = [c for k, c in hmma.items() if k == f"{name}<{d}>" or k.startswith(f"{name}<{d}, ")]
                if not counts or not all(counts):
                    bare.append(f"{name}<{d}>")
    if bare:
        raise AssertionError(f"bf16 kernels without tensor-core (HMMA) instructions: {bare}")
    _phase("build", t0, f"{len(reports)} of {len(build.SOURCES)} sources compiled; HMMA in every bf16 K1-K4 kernel")

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
        for d in WIDTH_CASES:  # head widths with no kernel instance: each head padded to the next
            cases[f"d={d} {dtype}"] = _attention_case(64, 12, 384, 4 * d, 4, dtype, narrow, gen)
    for name, row in cases.items():
        print(f"  K1 {name}: {row['shape']} err {row['max_abs_err']:.3g} "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    _phase("k1-vs-plain", t0, f"{len(cases)} cases within 2e-2 (bf16) / 1e-4 (f32)")

    t0 = time.perf_counter()
    q8 = {}
    for dtype in ("bfloat16", "float32"):
        for name, mask in (("pass1", mask1[t_mid]), ("pass2", mask2[t_mid])):
            q8[f"{name} {dtype}"] = _attention_case(LANES, *mask.shape, 256, 8, dtype, mask, gen, int8=True)
        q8[f"narrow {dtype}"] = _attention_case(64, 12, 384, 64, 4, dtype, narrow, gen, int8=True)
        q8[f"masked rows {dtype}"] = _attention_case(LANES, *dead.shape, 256, 8, dtype, dead, gen, int8=True)
        for d in WIDTH_CASES:
            q8[f"d={d} {dtype}"] = _attention_case(64, 12, 384, 4 * d, 4, dtype, narrow, gen, int8=True)
    for name, row in q8.items():
        print(f"  K2 {name}: {row['shape']} err {row['max_abs_err']:.3g} "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library (SDPA over "
              f"dequantized K/V) {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    detail = _quantize_rows_on_card(gen)
    _phase("k2-vs-plain", t0, f"{len(q8)} cases within 2e-2 (bf16) / 1e-4 (f32); {detail}")

    # the families' decode shapes under the masks their rollouts give the
    # first pass of step 45; the 3-pass decode's t-1 action pass at t = 0
    # sees no key at all
    t0 = time.perf_counter()
    recorded = {case: decode_masks(case, t_mid + 1, "cuda") for case in ("dt", "il", "trajeglish", "3-pass")}
    family_masks = {case: masks[t_mid][0] for case, masks in recorded.items()}
    family_masks["3-pass t=0"] = recorded["3-pass"][0][0]
    if family_masks["3-pass t=0"].any():
        raise AssertionError("expected every row of the 3-pass decode's t = 0 action pass to see no key")
    fam_k1, fam_k2 = {}, {}
    for name, mask in family_masks.items():
        for dtype in ("bfloat16", "float32"):
            fam_k1[f"{name} {dtype}"] = _attention_case(LANES, *mask.shape, 256, 8, dtype, mask, gen)
        fam_k2[f"{name} bfloat16"] = _attention_case(LANES, *mask.shape, 256, 8, "bfloat16", mask, gen, int8=True)
    for kname, rows in (("K1", fam_k1), ("K2", fam_k2)):
        for name, row in rows.items():
            print(f"  {kname} {name}: {row['shape']} err {row['max_abs_err']:.3g} "
                  f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                  f"library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    dt_row = fam_k1["dt bfloat16"]
    _phase("k1-k2-family-shapes", t0,
           f"{len(fam_k1) + len(fam_k2)} cases within 2e-2 (bf16) / 1e-4 (f32); DT's (Q, N) = (48, 1536) in bf16: "
           f"K1 {dt_row['ms']:.4f} ms, plain {dt_row['plain_ms']:.4f} ms, SDPA (bool mask) "
           f"{dt_row['library_ms']:.4f} ms, bound {dt_row['bound_ms']:.4f} ms")

    t0 = time.perf_counter()
    ft = _flash_main(gen)
    flash = {"train-step bfloat16 p=0.1": ft["check"]}
    for dtype in ("bfloat16", "float32"):
        for p in (0.0, 0.1):
            flash[f"train-shape {dtype} p={p}"] = _flash_case(4, 32, 24, 3, 8, 32, dtype, p, gen)
    flash["train-step bfloat16 p=0.0"] = ft["check_p0"]
    for dtype in ("bfloat16", "float32"):
        flash[f"ragged {dtype}"] = _flash_case(4, 29, 23, 3, 8, 32, dtype, 0.1, gen)
        flash[f"strict {dtype}"] = _flash_case(4, 12, 24, 3, 8, 32, dtype, 0.1, gen, own=True)
        flash[f"window {dtype}"] = _flash_case(4, 16, 24, 3, 8, 32, dtype, 0.1, gen, window=5)
    flash["narrow bfloat16"] = _flash_case(4, 32, 24, 3, 4, 16, "bfloat16", 0.1, gen)
    flash["wide bfloat16"] = _flash_case(4, 32, 24, 3, 4, 64, "bfloat16", 0.1, gen)
    flash["wide ragged strict bfloat16 p=0"] = _flash_case(2, 9, 7, 3, 2, 64, "bfloat16", 0.0, gen, own=True)
    flash["narrow window 2-token bfloat16"] = _flash_case(3, 20, 5, 2, 4, 16, "bfloat16", 0.1, gen, window=3)
    for d in WIDTH_CASES:  # head widths with no kernel instance: each head padded to the next
        flash[f"d={d} float32"] = _flash_case(4, 12, 24, 3, 4, d, "float32", 0.1, gen)
        flash[f"d={d} ragged strict bfloat16"] = _flash_case(2, 9, 7, 3, 4, d, "bfloat16", 0.1, gen, own=True)
    widths = {d: _flash_width_case(gen, d) for d in WIDTH_CASES}
    for d, row in widths.items():
        flash[f"d={d} train layout bfloat16"] = row
    for name, row in flash.items():
        print(f"  K3/K4 {name}: {row['shape']} output err {row['out_err']:.3g}, "
              f"gradient err {row['grad_err']:.3g} of max |grad| ({row['grad_abs_err']:.3g} absolute)")
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = ft["bound"]["fwd"], ft["bound"]["bwd"]
    print(f"  K3 forward, B=16 T=2304 H=256/8 bf16 (tensor cores): kernel {ft['fwd_ms']:.4f} ms at p=0.1, "
          f"{ft['fwd_ms_p0']:.4f} ms at p=0; bound {fwd_bound:.4f} ms ({fwd_by}; {ft['bound']['pairs']} visible "
          f"pairs), plain {ft['plain_fwd_ms']:.4f} ms, library (SDPA, bool mask, p=0) {ft['library_fwd_ms']:.4f} ms")
    print(f"  K4 backward, same shape: kernel {ft['bwd_ms']:.4f} ms at p=0.1, {ft['bwd_ms_p0']:.4f} ms at p=0; "
          f"bound {bwd_bound:.4f} ms ({bwd_by}), plain (autograd) {ft['plain_bwd_ms']:.4f} ms, library (SDPA "
          f"backward, p=0) {ft['library_bwd_ms']:.4f} ms")
    for d, row in widths.items():
        print(f"  K3/K4 at d = {d} (padded to {kernel_head_dim(d)}), {row['shape']}: K3 {row['fwd_ms']:.4f} ms, bound "
              f"{row['fwd_bound_ms']:.4f} ms ({row['fwd_bound_by']}), plain {row['plain_fwd_ms']:.4f} ms, library "
              f"(SDPA, bool mask, p=0) {row['library_fwd_ms']:.4f} ms; K4 {row['bwd_ms']:.4f} ms, bound "
              f"{row['bwd_bound_ms']:.4f} ms ({row['bwd_bound_by']}), plain (autograd) {row['plain_bwd_ms']:.4f} ms, "
              f"library (SDPA backward, p=0) {row['library_bwd_ms']:.4f} ms; bounds at the true width")
    _phase("k3-k4-vs-plain", t0, f"{len(flash)} cases within 2e-2 / 5e-2 (bf16), 1e-4 / 1e-4 (f32)")

    t0 = time.perf_counter()
    fam_flash = {}
    for name, B, K, state_index in (("trajeglish", 16, 1, 0), ("dt", 16, 3, 1), ("il", 4, 2, 0)):
        for p in (0.0, 0.1):
            fam_flash[f"{name} p={p}"] = _flash_family_case(B, K, state_index, p, gen)
    for name, row in fam_flash.items():
        print(f"  K3/K4 {name}: {row['shape']} output err {row['out_err']:.3g}, gradient err {row['grad_err']:.3g} "
              f"of max |grad|; K3 {row['fwd_ms']:.4f} ms (bound {row['fwd_bound_ms']:.4f}), K4 {row['bwd_ms']:.4f} "
              f"ms (bound {row['bwd_bound_ms']:.4f})")
    _phase("k3-k4-family-shapes", t0, f"{len(fam_flash)} cases within 2e-2 / 5e-2 (bf16)")

    t0 = time.perf_counter()
    _phase("golden-full", t0, _golden_full())

    t0 = time.perf_counter()
    _phase("golden-families", t0, _golden_families())

    t0 = time.perf_counter()
    detail = "; ".join(_small_agreement("ctrl_sim", {"model.kv_cache_dtype": kv}) for kv in ("bfloat16", "int8"))
    _phase("small-agreement", t0, detail)

    t0 = time.perf_counter()
    detail = "; ".join(_small_agreement(family, extra) for family, extra in (
        ("dt", None), ("il", None), ("trajeglish", None), ("ctrl_sim", {"eval.streaming_passes": 3})))
    _phase("families-small-agreement", t0, detail)

    t0 = time.perf_counter()
    cfgs, models, sc, controlled, tilt = full_width_rollout(SEED)
    params = sum(p.numel() for p in models["bf16"].parameters())
    _phase("setup", t0, f"{LANES} scenes, {params} params, contacts on")

    rollout_s, rollout_launches = {}, {}
    for phase, case in (("rollout", "bf16"), ("rollout-int8", "int8"), ("rollout-contacts-off", "contacts-off")):
        t0 = time.perf_counter()
        c = cfgs[case]
        elapsed, launched, name = _rollout(phase, c, models[case], sc, controlled, tilt)
        rollout_s[phase], rollout_launches[phase] = elapsed, launched
        contacts = "on" if c.sim.resolve_contacts else "off"
        _phase(phase, t0, f"{LANES} lanes x {c.sim.steps} steps, {c.model.kv_cache_dtype} cache, contacts "
               f"{contacts}, in {elapsed:.3f}s = {LANES * c.sim.steps / elapsed:.1f} env-steps/s on this card (one "
               f"cold run, not a benchmark); {name} launches {launched}")
    k1_launches, k2_launches = rollout_launches["rollout"], rollout_launches["rollout-int8"]

    t0 = time.perf_counter()
    family_launches = {}
    for case in FAMILY_CASES:
        c = cfgs[case]
        elapsed, family_launches[case], name = _rollout(f"families-rollout {case}", c, models[case], sc,
                                                       controlled, tilt)
        print(f"  {case}: {LANES} lanes x {c.sim.steps} steps, {c.model.kv_cache_dtype} cache, contacts on, "
              f"{_decode_passes(c)} pass(es) a step, in {elapsed:.3f}s cold = {LANES * c.sim.steps / elapsed:.1f} "
              f"env-steps/s on this card (one cold run, not a benchmark); {name} launches {family_launches[case]}",
              flush=True)
    _phase("families-rollout", t0, f"{len(FAMILY_CASES)} rollouts, each kernel launched as expected, outputs finite")
    del sc, models
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    detail = _train_small_agreement()
    _phase("train-small-agreement", t0, detail)

    t0 = time.perf_counter()
    train = _train_full(t0)
    k3_launches, k4_launches = train["launches"]

    t0 = time.perf_counter()
    store = train.pop("store")
    fam_train = _train_families(store)
    _phase("families-train", t0, f"{FAMILY_TRAIN_STEPS} full-width steps each of {', '.join(fam_train)} on K3/K4, "
           f"losses finite")

    t0 = time.perf_counter()
    detail = "; ".join(_small_agreement(family, exact=True, groups=groups) for family, groups in (
        ("ctrl_sim", False), ("dt", False), ("ctrl_sim", True)))
    _phase("eval-small-agreement", t0, detail)

    t0 = time.perf_counter()
    ev = _eval_exact()
    k3_eval = _flash_eval_shape(gen, ev["EG"])
    k3_b32 = _flash_eval_shape(gen, 32)  # one focal group a scene
    m = ev["metrics"]
    for label, row in (("the exact rollout's decode shape", k3_eval), ("one group a scene", k3_b32)):
        print(f"  K3 at {label}, {row['shape']}: err {row['max_abs_err']:.3g}, kernel {row['ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, library (SDPA, bool "
              f"mask) {row['library_ms']:.4f} ms; a launch under inference_mode holds "
              f"{row['inference_mode_bytes_held']} bytes (its output) afterwards", flush=True)
    _phase("eval-exact", t0,
           f"{ev['E']} scenes in one chunk, focal groups a scene {ev['groups_per_scene']}, padded to G = {ev['G']} "
           f"(EG = {ev['EG']}), {ev['evaluated']} vehicles evaluated, "
           f"90 steps, contacts on; evaluate {ev['wall_s']:.3f} s (one cold run on this card, not a benchmark); "
           f"peak memory {ev['peak_gib']:.2f} GiB; K3 launches {ev['launches']}, K4/K1/K2 0; tile table built "
           f"{ev['tables_built']} time(s); goal {m['goal']:.4f}, collision {m['collision_rate']:.4f}, offroad "
           f"{m['offroad_rate']:.4f}, ade {m['ade']:.4f}, fde {m['fde']:.4f}, lin_speed_jsd "
           f"{m['lin_speed_jsd']:.4f}, nearest_dist_jsd {m['nearest_dist_jsd']:.4f}")

    t0 = time.perf_counter()
    G, detail = _eval_multigroup(ev["cfg"], ev["model"])
    k3_multigroup = _flash_eval_shape(gen, 8 * G)
    _phase("eval-multigroup", t0, f"{detail}; K3 at B = {8 * G}: err {k3_multigroup['max_abs_err']:.3g}, kernel "
           f"{k3_multigroup['ms']:.4f} ms, bound {k3_multigroup['bound_ms']:.4f} ms, plain "
           f"{k3_multigroup['plain_ms']:.4f} ms, SDPA {k3_multigroup['library_ms']:.4f} ms")

    t0 = time.perf_counter()
    _phase("eval-streaming", t0, _eval_streaming(ev["cfg"], ev["model"], ev["scenes"]))

    t0 = time.perf_counter()
    _phase("eval-planner", t0, _eval_planner(ev["cfg"], ev["model"]))
    ev_launches = ev["launches"]
    del ev
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _phase("finetune", t0, _finetune(store))
    del store
    torch.cuda.empty_cache()
    r05_k1 = _trained_phases(gen)
    _ctg_phases()

    main_rows = [cases["pass1 bfloat16"], cases["pass2 bfloat16"]]  # the path's two shapes, 360 launches each
    mean = lambda key: statistics.fmean(r[key] for r in main_rows)  # noqa: E731
    q8_rows = [q8["pass1 bfloat16"], q8["pass2 bfloat16"]]
    mean_q8 = lambda key: statistics.fmean(r[key] for r in q8_rows)  # noqa: E731
    main_flash = ft["check"]  # the inputs the kernels were timed on
    def decode_family_rows(rows, rollouts):
        """The bf16 rows of the family shapes, each with the launches of the
        family rollout (``rollouts``: shape -> rollout case) it belongs to."""
        return [{"case": name, "shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "library_ms": r["library_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "max_abs_err": r["max_abs_err"],
                 "launches_per_chunk": family_launches.get(rollouts.get(name.removesuffix(" bfloat16")))}
                for name, r in rows.items() if name.endswith(" bfloat16")]

    def flash_family_rows(key):
        return [{"case": name, "shape": r["shape"], "ms": r[f"{key}_ms"], "bound_ms": r[f"{key}_bound_ms"],
                 "max_abs_err": r["out_err"] if key == "fwd" else r["grad_abs_err"],
                 "launches_per_step": fam_train[name.split(" ")[0]]["launches_per_step"]}
                for name, r in fam_flash.items()]

    def width_rows(rows):
        """K1's or K2's rows at the head widths without an instance (padded)."""
        return [{"case": name, **r} for name, r in rows.items() if name.startswith("d=")]

    def flash_width_rows(key):
        return [{"case": f"d={d}", "shape": r["shape"], "ms": r[f"{key}_ms"], "bound_ms": r[f"{key}_bound_ms"],
                 "bound_by": r[f"{key}_bound_by"], "padded_to": kernel_head_dim(d),
                 "plain_ms": r[f"plain_{key}_ms"], "library_ms": r[f"library_{key}_ms"],
                 "max_abs_err": r["out_err"] if key == "fwd" else r["grad_abs_err"]} for d, r in widths.items()]

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
            "rollout_s": rollout_s["rollout"],
            "implementation": DECODE_IMPLEMENTATION,
            "family_shapes": decode_family_rows(fam_k1, {"dt": "dt", "il": "il", "trajeglish": "trajeglish",
                                                           "3-pass": "3-pass", "3-pass t=0": "3-pass"}),
            "head_width_cases": width_rows(cases),
            "r05_shape": [{**r, "kernel": "decode_attention_kernel<16> (f32)"} for r in r05_k1],
        },
        {
            "name": "cached_decode_attention_q8",
            "route": "cuda",
            "source": "ctrl_sim_tpu_torch/csrc/decode_attention_q8.cu",
            "replaces": "ctrl_sim_tpu/ops/attention.py:232",
            "launches": k2_launches,
            "max_abs_err": max(r["max_abs_err"] for r in q8_rows),
            "ms": mean_q8("ms"),
            "kernel_ms": mean_q8("ms"),
            "plain_ms": mean_q8("plain_ms"),
            "bound_ms": mean_q8("bound_ms"),
            "bound_by": q8_rows[0]["bound_by"],
            "library_ms": mean_q8("library_ms"),
            "library": "F.scaled_dot_product_attention over K/V dequantized to bf16 beforehand (not timed); "
                       "not the same function, it reads twice K2's bytes",
            "rollout_s": rollout_s["rollout-int8"],
            "family_shapes": decode_family_rows(fam_k2, {"dt": "dt-int8"}),
            "head_width_cases": width_rows(q8),
            "implementation": DECODE_IMPLEMENTATION + "; int8 chunks widened to bf16 in shared memory, "
                              "k_scale on the scores, v_scale on the weights before their bf16 rounding",
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
            "ms_dropout_0": ft["fwd_ms_p0"],
            "plain_ms": ft["plain_fwd_ms"],
            "bound_ms": fwd_bound,
            "bound_by": fwd_by,
            "library_ms": ft["library_fwd_ms"],
            "shape": "B=16 T=2304 H=256/8 bf16 dropout 0.1 (ms_dropout_0: dropout 0, as library_ms)",
            "implementation": IMPLEMENTATION,
            "family_shapes": flash_family_rows("fwd"),
            "head_width_cases": flash_width_rows("fwd"),
            "exact_eval_shape": {**k3_eval, "launches_per_chunk": ev_launches},
            "exact_eval_one_group_shape": {**k3_b32, "launches_per_chunk": None},
            "multigroup_eval_shape": {**k3_multigroup, "launches_per_chunk": ev_launches},
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
            "ms_dropout_0": ft["bwd_ms_p0"],
            "plain_ms": ft["plain_bwd_ms"],
            "bound_ms": bwd_bound,
            "bound_by": bwd_by,
            "library_ms": ft["library_bwd_ms"],
            "shape": "B=16 T=2304 H=256/8 bf16 dropout 0.1 (ms_dropout_0: dropout 0, as library_ms)",
            "implementation": IMPLEMENTATION,
            "family_shapes": flash_family_rows("bwd"),
            "head_width_cases": flash_width_rows("bwd"),
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
