"""Times the bf16 decode kernels K1 and K2 of the PyTorch port in a given
checkout, at the rollout's two decode shapes, DT's and the 3-pass
decode's, with ``chip_smoke.py``'s yardstick, so that two trees can be
compared in one call on one card:

    python tools/time_decode_kernels.py ROOT

ROOT is a checkout of the repo (this one, or another commit unpacked with
``git archive``): its ``ctrl_sim_tpu_torch`` is imported and its kernels are
built. The inputs are ``chip_smoke.py``'s: 256 lanes, the stream masks at
t = 45 (pass 1: Q = 32, pass 2: Q = 16; N = 1536), and the masks that
DT's rollout (Q = 48) and the 3-pass decode's (its first pass, Q = 16)
give their first decode pass at t = 45 (``rollout/setup.py:decode_masks``,
N = 1536), H = 256 = 8 heads x 32, random unit normals from a seed (the
int8 cache by ``quantize_rows``).
Each kernel is first held against its plain version (2e-2). Prints the
card's name and power limit, then one JSON line: per kernel and pass, the
median ms of runs of 10 launches (``chip_smoke.py``'s ``_median_ms``) and of
runs of one launch, and the host's ms to enqueue one call (``host_ms``: the
wrapper's Python, its tensor operations and the launch, tensor maps
included). Run parent, change, change, parent in one call and
compare only within it. Needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
LANES, SLOTS, WINDOW, TYPES, T_MID, SEED = 256, 16, 32, 3, 45, 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_ms(fn, calls: int = 100, reps: int = 15) -> float:
    """The host's milliseconds to enqueue one call: ``calls`` calls in a
    row on the host's clock, without a sync (the card runs behind them), the
    median of ``reps`` such runs."""
    import statistics
    import time

    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def main(root: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_decode_kernels: no CUDA device", file=sys.stderr)
        return 2
    smoke = _chip_smoke()
    sys.path.insert(0, str(Path(root).resolve()))
    from ctrl_sim_tpu_torch.ops import attention
    from ctrl_sim_tpu_torch.ops.masks import stream_step_masks
    from ctrl_sim_tpu_torch.rollout.setup import decode_masks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    pass1, pass2 = (m[T_MID] for m in stream_step_masks(T_MID + 1, WINDOW, SLOTS, TYPES, 0, device="cuda"))
    shapes = {"pass1": pass1, "pass2": pass2,
              **{case: decode_masks(case, T_MID + 1, "cuda")[T_MID][0] for case in ("dt", "3-pass")}}
    rows = {}
    for kernel in ("K1", "K2"):
        for name, mask in shapes.items():
            Q, N = mask.shape
            q = torch.randn((LANES, Q, 256), generator=gen, device="cuda").bfloat16()
            k, v = (torch.randn((LANES, N, 256), generator=gen, device="cuda") for _ in range(2))
            if kernel == "K2":
                (k, ks), (v, vs) = attention.quantize_rows(k), attention.quantize_rows(v)
                args = (q, k, v, ks, vs, mask, 8)
                fn, plain = attention.cached_decode_attention_q8, attention.cached_decode_attention_q8_reference
            else:
                args = (q, k.bfloat16(), v.bfloat16(), mask, 8)
                fn, plain = attention.cached_decode_attention, attention.cached_decode_attention_reference
            visible = (mask != 0).any(dim=1)
            err = (fn(*args).float() - plain(*args).float())[:, visible].abs().max().item()
            if not err <= smoke.TOL["bfloat16"]:
                raise AssertionError(f"{kernel} {name} disagrees with its plain version: {err}")
            rows[f"{kernel} {name}"] = {"max_abs_err": err, "ms_runs_of_10": smoke._median_ms(lambda: fn(*args)),
                                        "ms_runs_of_1": smoke._median_ms(lambda: fn(*args), batch=1),
                                        "host_ms": _host_ms(lambda: fn(*args))}
    print(json.dumps({"root": root, "kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    raise SystemExit(main(sys.argv[1]))
