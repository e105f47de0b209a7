"""Scenario store: replayed offline data kept on the device, and train-batch
sampling (port of ``ctrl_sim_tpu/data/store.py``).

Scenes -> batched replay through physics (data/datagen.py) -> offline arrays
kept as tensors on the store's device (or an .npz cache on disk) -> per
step, sample scene indices with replacement and build the whole model batch
on the device (data/pipeline.py). No worker processes: the "dataloader" is
a gather.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data.ctg_pipeline import build_ctg_batch
from ctrl_sim_tpu_torch.data.datagen import OfflineArrays, generate_offline_data
from ctrl_sim_tpu_torch.data.pipeline import build_train_batch
from ctrl_sim_tpu_torch.data.scenario import Scenario, load_scenario_json, stack_scenarios, to_torch
from ctrl_sim_tpu_torch.device import resolve_device


def _arrays(scenario: Scenario, kind: type) -> dict:
    """The fields of ``scenario`` that hold a ``kind`` (no copies, unlike
    ``dataclasses.asdict``)."""
    out = {f.name: getattr(scenario, f.name) for f in dataclasses.fields(scenario)}
    return {k: v for k, v in out.items() if isinstance(v, kind)}


def load_json_dir(cfg: Config, directory: str, limit: int | None = None, native: bool = False) -> list[Scenario]:
    """The scenes of every ``*.json`` in ``directory``, sorted by name, the
    first ``limit`` of them; ``native`` picks the C++ loader
    (``data/native_loader.py``), which raises if it cannot be built."""
    files = sorted(glob.glob(os.path.join(directory, "*.json")))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no *.json scene files in {directory}")
    if native:
        from ctrl_sim_tpu_torch.data.native_loader import load_scenario_json_native as load
    else:
        load = load_scenario_json
    return [load(f, cfg) for f in files]


def _slice_scenario(scenario: Scenario, lo: int, hi: int) -> Scenario:
    return dataclasses.replace(scenario, **{k: v[lo:hi] for k, v in _arrays(scenario, np.ndarray).items()})


class ScenarioStore:
    """A replayed scenario set on one device, and its batch sampler."""

    def __init__(self, cfg: Config, scenario: Scenario, offline: OfflineArrays,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.scenario = to_torch(dataclasses.replace(scenario, name=""), self.device)
        self.offline = OfflineArrays(*(torch.as_tensor(x).to(self.device) for x in offline))
        self.num_scenes = self.offline.states.shape[0]

    @classmethod
    def from_json_dir(cls, cfg: Config, directory: str, limit: int | None = None,
                      replay_chunk: int = 64, device: torch.device | str | None = None,
                      native: bool = False) -> "ScenarioStore":
        """The scenes of every ``*.json`` in ``directory`` (sorted, the first
        ``limit``), loaded by the Python loader or, with ``native``, the C++
        one, and replayed as ``from_scenes`` replays them."""
        return cls.from_scenes(cfg, load_json_dir(cfg, directory, limit, native), replay_chunk, device)

    @classmethod
    def from_scenes(cls, cfg: Config, scenes: list[Scenario], replay_chunk: int = 64,
                    device: torch.device | str | None = None) -> "ScenarioStore":
        """Stack numpy scenes and replay them through physics on ``device``
        (the card unless the caller passes ``device="cpu"``),
        ``replay_chunk`` scenes at a time."""
        device = resolve_device(device)
        batch = stack_scenarios(scenes, cfg)
        n = batch.traj_position.shape[0]
        chunks = [
            generate_offline_data(cfg, to_torch(_slice_scenario(batch, i, min(i + replay_chunk, n)), device))
            for i in range(0, n, replay_chunk)
        ]
        offline = OfflineArrays(*(torch.cat(parts) for parts in zip(*chunks)))
        return cls(cfg, batch, offline, device)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "scenarios.npz"),
            **{k: v.cpu().numpy() for k, v in _arrays(self.scenario, torch.Tensor).items()},
        )
        np.savez_compressed(os.path.join(path, "offline.npz"),
                            **{k: v.cpu().numpy() for k, v in self.offline._asdict().items()})

    @classmethod
    def load(cls, cfg: Config, path: str, device: torch.device | str | None = None) -> "ScenarioStore":
        with np.load(os.path.join(path, "scenarios.npz")) as sc:
            scenario = Scenario(**{k: sc[k] for k in sc.files}, name="store")
        with np.load(os.path.join(path, "offline.npz")) as off:
            offline = OfflineArrays(**{k: off[k] for k in off.files})
        return cls(cfg, scenario, offline, device)

    def sample_batch(self, generator: torch.Generator | None, batch_size: int,
                     family: str = "ctrl_sim") -> dict:
        """Scene indices drawn with replacement, and their training batch
        built on the store's device; ``generator`` (on any device) makes
        every draw. ``family="ctg_plus_plus"`` builds the CTG++ diffusion
        batch (``data/ctg_pipeline.py``) in place of the token batch."""
        if family not in ("ctrl_sim", "ctg_plus_plus"):
            raise ValueError(f"unknown batch family: {family!r}")
        scen, off = self.take(self.draw_indices(generator, batch_size))
        build = build_ctg_batch if family == "ctg_plus_plus" else build_train_batch
        return build(self.cfg, scen, off, generator=generator)

    def draw_indices(self, generator: torch.Generator | None, n: int) -> torch.Tensor:
        """``n`` scene indices drawn uniformly with replacement by
        ``generator`` (on any device), on the store's device."""
        gdev = generator.device if generator is not None else self.device
        return torch.randint(0, self.num_scenes, (n,), generator=generator, device=gdev).to(self.device)

    def take(self, idx: torch.Tensor) -> tuple[Scenario, OfflineArrays]:
        """The scenes ``idx`` of the store and their offline arrays."""
        scen = dataclasses.replace(
            self.scenario, **{k: v[idx] for k, v in _arrays(self.scenario, torch.Tensor).items()}
        )
        return scen, OfflineArrays(*(x[idx] for x in self.offline))
