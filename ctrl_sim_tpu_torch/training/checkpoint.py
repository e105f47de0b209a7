"""Checkpointing with last-n / best-by-val_loss retention and auto-resume
(port of ``ctrl_sim_tpu/training/checkpoint.py``, whose orbax store is not
on the card's machine).

Each checkpoint is one ``step_<n>.pt`` written by ``torch.save``: the model
and optimizer state dicts and the step. The newest ``train.keep_last_n``
are kept, and so is the one with the lowest ``val_loss`` among those saved
with metrics. The config is snapshotted once as ``config.json`` next to
them. Saves are synchronous; ``wait`` exists for the JAX interface.
"""

from __future__ import annotations

import json
import os
import re

import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.training.trainer import Trainer, TrainState

_NAME = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    def __init__(self, cfg: Config, directory: str):
        self.cfg = cfg
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._metrics_path = os.path.join(self.directory, "metrics.json")
        cfg_path = os.path.join(self.directory, "config.json")
        if not os.path.exists(cfg_path):
            with open(cfg_path, "w") as f:
                f.write(cfg.to_json())

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def _metrics(self) -> dict[str, dict]:
        if not os.path.exists(self._metrics_path):
            return {}
        with open(self._metrics_path) as f:
            return json.load(f)

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(self.directory)) if m)

    def save(self, step: int, state: TrainState, metrics: dict | None = None) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save({"step": state.step, "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, tmp)
        os.replace(tmp, self._path(step))
        recorded = self._metrics()
        if metrics:
            recorded[str(step)] = {k: float(v) for k, v in metrics.items()}
        steps = self.all_steps()
        keep = set(steps[-self.cfg.train.keep_last_n:])
        scored = [s for s in steps if "val_loss" in recorded.get(str(s), {})]
        if scored:
            keep.add(min(scored, key=lambda s: recorded[str(s)]["val_loss"]))
        for s in steps:
            if s not in keep:
                os.remove(self._path(s))
                recorded.pop(str(s), None)
        with open(self._metrics_path, "w") as f:
            json.dump(recorded, f)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Load a checkpoint (the latest unless ``step`` is given) into
        ``state``'s model and optimizer, in place, and return it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(state.model.parameters()).device
        saved = torch.load(self._path(step), map_location=device, weights_only=True)
        state.model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        return state

    @staticmethod
    def load_config(directory: str) -> dict:
        with open(os.path.join(directory, "config.json")) as f:
            return json.load(f)


def checkpoint_config(directory: str, overrides: dict | None = None) -> Config:
    """The Config of a checkpoint directory's ``config.json`` (the shapes it
    was trained at), with ``overrides`` ({dotted key: value}) applied."""
    from ctrl_sim_tpu_torch.config import _set_dotted, config_from_dict

    cfg = config_from_dict(CheckpointManager.load_config(directory))
    for key, value in (overrides or {}).items():
        cfg = _set_dotted(cfg, key, value)
    return cfg


def restore_model(cfg: Config, directory: str, device: torch.device | str | None = None, step: int | None = None):
    """(model in eval mode, step) of a checkpoint directory's step (the
    latest unless ``step`` is given), built from ``cfg`` on ``device`` (the
    card unless the caller passes "cpu")."""
    from ctrl_sim_tpu_torch.models.ctrl_sim import CtRLSim

    trainer = Trainer(cfg, device=device)
    state = trainer.state_from_model(CtRLSim(cfg, device=trainer.device))
    state = CheckpointManager(cfg, directory).restore(state, step=step)
    state.model.eval()
    return state.model, state.step
