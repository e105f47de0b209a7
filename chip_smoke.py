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
   trajeglish on the same store, with the same checks.

Then one line ``{"kernels": [...]}``, each kernel's row with its times
at the other families' shapes under ``family_shapes``, and, last, the
device line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def _attention_case(B, Q, N, H, heads, dtype, mask, gen, int8=False):
    """K1 (or, with ``int8``, K2 over a cache quantized from unit normals by
    ``quantize_rows``) against its plain version on one input; returns the
    measured row. The library yardstick for K2 runs over the K/V
    dequantized to q's dtype beforehand."""
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
    return {
        "shape": f"B={B} Q={Q} N={N} H={H}/{heads} {dtype}" + (" int8 K/V" if int8 else ""),
        "max_abs_err": err,
        "ms": _median_ms(lambda: kernel(*args)),
        "plain_ms": _median_ms(lambda: plain(*args), batch=1),
        "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bool_mask)),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


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
    import torch.nn.functional as F

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
            lambda: fa.flash_mha_reference(q, k, v, spec, heads, 0.1, seed), reps=10, warmup=2, batch=1)
    ref_out, _ = fa.flash_mha_reference(*leaves, spec, heads, 0.1, seed)
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
    from ctrl_sim_tpu_torch.ops import flash_attention as fa
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
        f0 = fa.flash_mha_fwd.launches
        with torch.no_grad():
            out = model(batch)
        torch.cuda.synchronize()
        launched = fa.flash_mha_fwd.launches - f0
        expected = cfg.model.num_decoder_layers if flash else 0
        if launched != expected:
            raise AssertionError(f"golden forward {dtype} flash={flash}: K3 launched {launched} times, "
                                 f"expected {expected}")
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
    from ctrl_sim_tpu_torch.ops import flash_attention as fa
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
        fa.flash_mha_fwd.launches = 0
        with torch.no_grad():
            out = model(batch)
        torch.cuda.synchronize()
        if fa.flash_mha_fwd.launches != cfg.model.num_decoder_layers:
            raise AssertionError(f"golden {family}: K3 launched {fa.flash_mha_fwd.launches} times, expected "
                                 f"{cfg.model.num_decoder_layers}")
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


def _small_agreement(family: str = "ctrl_sim", extra: dict | None = None) -> str:
    """The toy-width rollout (contacts on) of a model family (with
    ``extra`` overrides) on the card against the same rollout on the CPU
    (plain kernels), with the CPU run's draws replayed on the card."""
    import torch

    from ctrl_sim_tpu_torch.config import _set_dotted, preset
    from ctrl_sim_tpu_torch.data import stack_scenarios, synthetic_scenario, to_torch
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim
    from ctrl_sim_tpu_torch.params import init_params
    from ctrl_sim_tpu_torch.rollout.streaming import PolicySampler, run_streaming

    cfg = preset(family)
    for key, value in {
        "model.hidden_dim": 64, "model.num_heads": 4, "model.dim_feedforward": 128,
        "model.num_transformer_encoder_layers": 1, "model.num_decoder_layers": 2,
        "model.compute_dtype": "float32", "waymo.max_num_agents": 12, "sim.max_agents": 12,
        "eval.agent_slots": 8, "waymo.train_context_length": 8, "sim.steps": 16,
        "sim.history_steps": 4, **(extra or {}),
    }.items():
        cfg = _set_dotted(cfg, key, value)
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
    label = f"{family} {extra}" if extra else family
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
    return {"launches": launches, "store": store}


def _train_families(store) -> dict:
    """``FAMILY_TRAIN_STEPS`` full-width train steps of DT, IL and
    trajeglish (dropout 0.1, global batch 64 as 16 x 4, the default
    family's store of replayed scenes): every loss finite, and K3/K4
    launched 4 layers x 4 microbatches = 16 times each per step."""
    import torch

    from ctrl_sim_tpu_torch.ops import flash_attention as fa
    from ctrl_sim_tpu_torch.profile_train import full_width_setup

    rows = {}
    for family in FAMILY_FLAGS:
        cfg, store, state, train_step, data_gen, dropout_gen, _ = full_width_setup(SEED, family, store)
        per_step = cfg.model.num_decoder_layers * cfg.train.accum_steps
        step_ms = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.flash_mha_fwd.launches = fa.flash_mha_bwd.launches = 0
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
        launches = (fa.flash_mha_fwd.launches, fa.flash_mha_bwd.launches)
        expected = FAMILY_TRAIN_STEPS * per_step
        if launches != (expected, expected):
            raise AssertionError(f"{family}: {FAMILY_TRAIN_STEPS} train steps launched K3/K4 {launches} times, "
                                 f"expected {expected} each")
        T = cfg.waymo.train_context_length * cfg.waymo.max_num_agents * cfg.model.num_token_types
        rows[family] = {"T": T, "launches_per_step": launches[0] // FAMILY_TRAIN_STEPS, "step_ms": step_ms,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "loss": values[0]}
        print(f"  {family}: T = {T}, loss {values[0]:.4f}, step ms {', '.join(f'{x:.1f}' for x in step_ms)} "
              f"(steady median {statistics.median(step_ms[1:]):.1f}), peak memory "
              f"{rows[family]['peak_gib']:.2f} GiB, K3/K4 launches {launches}", flush=True)
        del state, train_step
        torch.cuda.empty_cache()
    return rows


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
    torch.cuda.synchronize()
    attention.cached_decode_attention.launches = 0
    attention.cached_decode_attention_q8.launches = 0
    start = time.perf_counter()
    out = run_streaming(cfg, model, sc, controlled, torch.Generator(device="cuda").manual_seed(SEED), tilt)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launched = kernel.launches
    other = attention.cached_decode_attention.launches + attention.cached_decode_attention_q8.launches - launched
    steps = cfg.sim.steps
    expected = _decode_passes(cfg) * cfg.model.num_decoder_layers * steps
    if launched != expected or other:
        raise AssertionError(f"{phase}: {kernel.__name__} launched {launched} times on the main path, expected "
                             f"{expected}; the other decode kernel {other} times, expected 0")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ctrl_sim_tpu_torch.ops import attention, build
        from ctrl_sim_tpu_torch.ops import flash_attention as fa
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
            for d in fa.HEAD_DIMS:  # every instance of the head width (and of the row tiles)
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
    fam_train = _train_families(train.pop("store"))
    _phase("families-train", t0, f"{FAMILY_TRAIN_STEPS} full-width steps each of {', '.join(fam_train)} on K3/K4, "
           f"losses finite")

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
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
