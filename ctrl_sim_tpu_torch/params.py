"""Parameters of the port's models (``CtRLSim``, ``CTGPlusPlus``): random
initialization from a seeded ``torch.Generator``, and the mapping of the
JAX models' flax params.

``from_flax_params`` takes a JAX model's params as nested dicts of numpy
arrays (``{"params": {"encoder": ..., "decoder": ...}}`` or the inner dict;
for CTG++ ``{"diffusion": {"model": ...}, "rtg_model": ...}``) and returns
the port's ``state_dict``:

- a flax ``Dense`` kernel [in, out] becomes the Linear weight [out, in];
- a ``LayerNorm`` scale and an ``Embed`` embedding become ``weight``;
- ``decoder_layer_i`` -> ``layers.i``, ``encoder_layer_i`` ->
  ``encoder_layers.i``, and inside an ``MLPLayer`` ``Dense_0`` / ``LayerNorm_0``
  / ``Dense_1`` -> ``fc1`` / ``norm`` / ``fc2``; other auto-named flax
  modules (CTG++'s ``SingleInputEmbedding``) keep their names.

``flax_path`` is the inverse of that renaming for one parameter of a port
model: its path in the JAX model's params.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn

from ctrl_sim_tpu_torch.models.layers import Dense, Embed, LayerNorm, MLPLayer

_RENAMES = {"Dense_0": "fc1", "LayerNorm_0": "norm", "Dense_1": "fc2"}
_INVERSE = {v: k for k, v in _RENAMES.items()}
_LAYER_LISTS = {"layers": "decoder_layer", "encoder_layers": "encoder_layer"}


def _flatten(tree, prefix=()):
    """(module path, leaf) pairs; inside an ``MLPLayer`` (a dict of exactly
    its three auto-named modules) the names become the port's."""
    mlp = set(tree) == set(_RENAMES)
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (_RENAMES[key] if mlp else key,))
        else:
            yield prefix + (key,), value


def from_flax_params(tree: dict) -> dict[str, torch.Tensor]:
    """The port's state_dict (fp32 CPU tensors) from the JAX model's params."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, value in _flatten(tree):
        arr = np.asarray(value, dtype=np.float32)
        *mods, leaf = path
        names = []
        for m in mods:
            hit = re.fullmatch(r"(decoder|encoder)_layer_(\d+)", m)
            if hit:
                names += ["layers" if hit.group(1) == "decoder" else "encoder_layers", hit.group(2)]
            else:
                names.append(m)
        if leaf == "kernel":
            names.append("weight")
            arr = arr.T
        elif leaf in ("scale", "embedding"):
            names.append("weight")
        else:
            names.append(leaf)
        out[".".join(names)] = torch.tensor(arr)
    return out


def flax_path(model: nn.Module, name: str) -> tuple[str, ...]:
    """The path of the port's parameter ``name`` (a ``named_parameters``
    name of ``model``) in the JAX model's params, ``("params", ...)``: the
    inverse of ``from_flax_params``'s renaming."""
    *mods, leaf = name.split(".")
    path, module, i = ["params"], model, 0
    while i < len(mods):
        part = mods[i]
        if part in _LAYER_LISTS and i + 1 < len(mods):
            module = module.get_submodule(f"{part}.{mods[i + 1]}")
            path.append(f"{_LAYER_LISTS[part]}_{mods[i + 1]}")
            i += 2
            continue
        parent, module = module, module.get_submodule(part)
        path.append(_INVERSE[part] if isinstance(parent, MLPLayer) else part)
        i += 1
    if leaf == "weight" and isinstance(module, Dense):
        leaf = "kernel"
    elif leaf == "weight" and isinstance(module, LayerNorm):
        leaf = "scale"
    elif leaf == "weight" and isinstance(module, Embed):
        leaf = "embedding"
    return tuple(path) + (leaf,)


def _xavier_(t: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=gen))


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX model's initializers (reference train_utils.py:14-79):
    Xavier-uniform linear weights with zero bias, N(0, 0.02) embeddings,
    unit LayerNorm scales, a Xavier-uniform map seed. Values are drawn on
    the CPU from ``generator``, so they depend on the seed and not on the
    device."""
    for module in model.modules():
        if isinstance(module, Dense):
            _xavier_(module.weight, module.in_features, module.out_features, generator)
            module.bias.zero_()
        elif isinstance(module, Embed):
            module.weight.copy_(torch.empty(module.weight.shape).normal_(0.0, 0.02, generator=generator))
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("map_seeds"):  # flax xavier on (1, 1, H): fan_in 1, fan_out H
            _xavier_(p, 1, p.shape[-1], generator)
