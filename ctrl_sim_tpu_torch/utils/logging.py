"""Experiment logging: the JSONL metrics sink (port of
``ctrl_sim_tpu/utils/logging.py``).

The sink is a local ``metrics.jsonl``, one JSON object per logged step.
The JAX package's optional wandb mirror is not ported: ``train.track``
prints that and logs to the sink alone. ``grad_norms`` is the reference's
per-parameter gradient 2-norm payload (models/ctrl_sim.py:231-238).
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import torch


class MetricsLogger:
    """Append-only JSONL metrics sink."""

    def __init__(self, save_dir: str, track: bool = False):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        if track:
            print("[log] the wandb mirror is not ported; JSONL sink only")

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        row = {"step": int(step), "ts": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._fh.close()


def grad_norms(grads: Mapping[str, torch.Tensor]) -> dict:
    """Per-parameter gradient 2-norms and the global norm, as a flat dict of
    0-d tensors keyed ``grad_2.0_norm/<name>`` and ``grad_2.0_norm_total``."""
    out = {}
    sq = None
    for name, g in grads.items():
        n2 = g.float().square().sum()
        sq = n2 if sq is None else sq + n2
        out[f"grad_2.0_norm/{name}"] = n2.sqrt()
    out["grad_2.0_norm_total"] = sq.sqrt() if sq is not None else torch.zeros(())
    return out
