"""Scenario store: replayed offline data kept on the device, and train-batch
sampling (frozen copy of the port's ``data/store.py``, its training path alone).

Scenes -> batched replay through physics (data/datagen.py) -> offline arrays
kept as tensors on the store's device (or an .npz cache on disk) -> per
step, sample scene indices with replacement and build the whole model batch
on the device (data/pipeline.py). No worker processes: the "dataloader" is
a gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.sim.config import Config
from benchmark.reference.sim.data.datagen import OfflineArrays, generate_offline_data
from benchmark.reference.sim.data.pipeline import build_train_batch
from benchmark.reference.sim.data.scenario import Scenario, stack_scenarios, to_torch
from benchmark.reference.sim.device import resolve_device


def _arrays(scenario: Scenario, kind: type) -> dict:
    """The fields of ``scenario`` that hold a ``kind`` (no copies, unlike
    ``dataclasses.asdict``)."""
    out = {f.name: getattr(scenario, f.name) for f in dataclasses.fields(scenario)}
    return {k: v for k, v in out.items() if isinstance(v, kind)}


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

    def sample_batch(self, generator: torch.Generator | None, batch_size: int) -> dict:
        """Scene indices drawn with replacement, and their training batch
        built on the store's device; ``generator`` (on any device) makes
        every draw."""
        scen, off = self.take(self.draw_indices(generator, batch_size))
        return build_train_batch(self.cfg, scen, off, generator=generator)

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
