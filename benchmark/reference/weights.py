"""Seeded weights that the port's model and the reference load alike.

The benchmark makes them itself, on the device, from the run's seed: one
draw of standard normals for every parameter at once, cut into the
parameters in name order and scaled per kind: dense and embedding weights
by 1/sqrt(fan-in) (the last axis), every other vector by 0.02; LayerNorm
scales 1 and offsets 0. Both models have the same parameter names and
shapes (the reference is a copy of the port's module tree), which
``load`` checks.
"""

from __future__ import annotations

import numpy as np
import torch

STREAMS = {"weights": 0, "data": 1, "dropout": 2, "scenes": 3, "chunks": 4, "check": 5, "warmup": 6}


def derive(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` drawn from (run
    seed, stream, index), so that streams do not overlap; any whole seed
    up to 2**64 is taken."""
    return int(np.random.SeedSequence([int(seed), STREAMS[stream], index]).generate_state(1, np.uint64)[0] >> 1)


def _layer_norm_params(model: torch.nn.Module) -> set[str]:
    return {f"{name}.{leaf}" for name, module in model.named_modules()
            if isinstance(module, torch.nn.LayerNorm) for leaf in ("weight", "bias")}


def make(model: torch.nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """The weights of ``model``'s parameters (fp32) for ``seed``."""
    norms = _layer_norm_params(model)
    named = [(n, p.shape) for n, p in model.named_parameters() if n not in norms]
    total = sum(int(np.prod(shape)) for _, shape in named)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in named:
        n = int(np.prod(shape))
        scale = 1.0 / float(shape[-1]) ** 0.5 if len(shape) >= 2 else 0.02
        out[name] = flat[at:at + n].view(shape) * scale
        at += n
    for name, p in model.named_parameters():
        if name in norms:
            out[name] = (torch.ones if name.endswith(".weight") else torch.zeros)(p.shape, device=device)
    return out


@torch.no_grad()
def load(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copies ``weights`` into ``model``; its parameter names and shapes
    must be those the weights were made for."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: {sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        if p.shape != weights[name].shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)} against {tuple(weights[name].shape)}")
        p.copy_(weights[name])
