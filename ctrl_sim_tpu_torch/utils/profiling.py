"""Profiling and observability (port of ``ctrl_sim_tpu/utils/profiling.py``).

``StepMeter`` tracks wall time per phase; a phase given a tensor to
materialize waits for that tensor's device first, so the time covers the
queued kernels and not just their launch. ``trace_annotation`` names a
span for ``torch.profiler`` traces and, on a card, for NVTX. ``grad_global_norms``
is the per-module gradient 2-norm payload, keyed by the JAX model's paths.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch
from torch import nn

from ctrl_sim_tpu_torch.params import flax_path


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (list, tuple)) else ()
    for value in values:
        found = _first_tensor(value)
        if found is not None:
            return found
    return None


class StepMeter:
    """Accumulates per-phase wall time and derived rates."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, materialize=None):
        """Time the block; ``materialize`` (a tensor, or a dict, list or
        tuple holding one) has its device synchronized before the clock
        stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            tensor = _first_tensor(materialize) if materialize is not None else None
            if tensor is not None and tensor.device.type == "cuda":
                torch.cuda.synchronize(tensor.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def rate(self, name: str, units_per_call: float) -> float:
        """units/second for a phase (e.g. env-steps per rollout call)."""
        if self.totals[name] == 0:
            return 0.0
        return self.counts[name] * units_per_call / self.totals[name]

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in self.totals
        }


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named span: ``torch.profiler.record_function``, and an NVTX range
    when a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def grad_global_norms(model: nn.Module, grads: dict | None = None) -> dict:
    """Gradient 2-norms per top-level module (the reference logs per-layer
    grad norms, models/ctrl_sim.py:231-238), keyed like the JAX function's:
    the first three keys of each parameter's path in the JAX model's params
    (``params.flax_path``), joined by "/". ``grads`` maps parameter names to
    gradients; by default the parameters' ``.grad``."""
    if grads is None:
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    agg: dict[str, float] = defaultdict(float)
    for name, g in grads.items():
        top = "/".join(flax_path(model, name)[:3])
        agg[top] += float(np.sum(np.square(g.detach().cpu().numpy().astype(np.float64))))
    return {k: float(np.sqrt(v)) for k, v in agg.items()}
