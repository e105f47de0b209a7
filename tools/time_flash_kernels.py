"""Times the bf16 training flash attention kernels K3 (forward) and K4
(backward) of the PyTorch port in a given checkout, so that two trees can be
compared in one call on one card:

    python tools/time_flash_kernels.py ROOT

ROOT is a checkout of the repo (this one, or another commit unpacked with
``git archive``): its ``ctrl_sim_tpu_torch`` is imported and its kernels are
built. The shapes are ``chip_smoke.py``'s, with inputs of unit normals from
a seed: the train step's (B = 16, T = 32 x 24 x 3 = 2304, H = 256 = 8 heads
x 32; K3 and K4 at dropout 0.1 and 0, K4 on the keep bits K3 saved where
the checkout's K3 saves them), the same layout at head widths 8 and 48
(padded to 16 and 64; dropout 0.1), and K3 forward only at dropout 0 at
the exact evaluation's B = 192, 96, 56, 32 and 24 lanes. K3 and K4 are
first held against the plain version on two rows of the train step's
input (2e-2 on outputs, 5e-2 of max |grad| on gradients). Prints the
card's name and power limit, then one JSON line of medians of runs of 10
launches (``chip_smoke.py``'s ``_median_ms``). Run parent, change, change,
parent in one call and compare only within it. Needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SEED, STEPS, AGENTS, TYPES, HEADS = 0, 32, 24, 3, 8
EVAL_LANES = (192, 96, 56, 32, 24)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(root: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_flash_kernels: no CUDA device", file=sys.stderr)
        return 2
    smoke = _chip_smoke()
    sys.path.insert(0, str(Path(root).resolve()))
    from ctrl_sim_tpu_torch.ops import flash_attention as fa

    saves_bits = "keep_bits" in inspect.signature(fa.flash_mha_fwd).parameters

    def fwd(q, k, v, spec, p, seed):
        res = fa.flash_mha_fwd(q, k, v, spec, HEADS, p, seed, **({"keep_bits": True} if saves_bits else {}))
        return res[0], res[1], (res[2] if saves_bits else None)

    def bwd(q, k, v, out, do, lse, keep, spec, p, seed):
        extra = {"keep": keep} if saves_bits else {}
        return fa.flash_mha_bwd(q, k, v, out, do, lse, spec, HEADS, p, seed, **extra)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    spec, seed = fa.MaskSpec(AGENTS, TYPES, 0, False, None), torch.tensor([7], device="cuda")
    rows = {}

    def train_case(name, d, dropouts):
        T = STEPS * AGENTS * TYPES
        q, k, v, do = (torch.randn((16, T, HEADS * d), generator=gen, device="cuda").bfloat16() for _ in range(4))
        for p in dropouts:
            out, lse, keep = fwd(q, k, v, spec, p, seed)
            if name == "train" and p > 0:  # held against the plain version on two rows
                grads = bwd(q, k, v, out, do, lse, keep, spec, p, seed)
                leaves = [x[:2].detach().float().requires_grad_(True) for x in (q, k, v)]
                want, want_lse = fa.flash_mha_reference(*leaves, spec, HEADS, p, seed)
                want_grads = torch.autograd.grad(want, leaves, do[:2].float())
                out_err = max((out[:2].float() - want).abs().max().item(), (lse[:2] - want_lse).abs().max().item())
                grad_err = max((g[:2].float() - w).abs().max().item() / w.abs().max().item()
                               for g, w in zip(grads, want_grads))
                if not (out_err <= smoke.TOL["bfloat16"] and grad_err <= smoke.GRAD_TOL["bfloat16"]):
                    raise AssertionError(f"K3/K4 disagree with the plain version: {out_err}, {grad_err}")
                rows["train_check"] = {"out_err": out_err, "grad_err": grad_err}
            rows[f"{name} p={p}"] = {
                "k3_ms": smoke._median_ms(lambda: fwd(q, k, v, spec, p, seed)),
                "k4_ms": smoke._median_ms(lambda: bwd(q, k, v, out, do, lse, keep, spec, p, seed)),
            }
        del q, k, v, do
        torch.cuda.empty_cache()

    train_case("train", 32, (0.1, 0.0))
    for d in (8, 48):
        train_case(f"d={d}", d, (0.1,))
    for lanes in EVAL_LANES:
        T = STEPS * AGENTS * TYPES
        q, k, v = (torch.randn((lanes, T, HEADS * 32), generator=gen, device="cuda").bfloat16() for _ in range(3))
        with torch.inference_mode():
            rows[f"eval B={lanes}"] = {"k3_ms": smoke._median_ms(lambda: fa.flash_mha_fwd(q, k, v, spec, HEADS))}
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "saves_keep_bits": saves_bits, "kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    raise SystemExit(main(sys.argv[1]))
