"""Adversarial finetuning data: CAT scenarios mixed with real replay (port of
``ctrl_sim_tpu/data/finetune.py``; reference RLWaymoDatasetCtRLSimFineTuning
+ RLWaymoDataModuleFineTuning).

A finetuning batch mixes real scenes with adversarial (CAT-attacked) ones,
``waymo.replay_ratio`` of it real. Both sets are drawn with replacement
every batch, which subsumes the reference's per-epoch re-sampling of the
real subset (dataset_ctrl_sim_finetuning.py:40-43). Each CAT sample carries
its focal (adversary) agent: the sample is centered on it
(``waymo.center_on_focal_agent``) and, with
``waymo.supervise_focal_agent``, the loss keeps only that agent.
"""

from __future__ import annotations

import dataclasses

import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data.datagen import OfflineArrays
from ctrl_sim_tpu_torch.data.pipeline import TrainDraws, build_train_batch
from ctrl_sim_tpu_torch.data.scenario import Scenario
from ctrl_sim_tpu_torch.data.store import ScenarioStore, _arrays


class FinetuningStore:
    """Samples mixed real / adversarial batches from two stores on one
    device."""

    def __init__(
        self,
        cfg: Config,
        real: ScenarioStore,
        simulated: ScenarioStore,
        focal_agent_idx,  # [num_simulated] adversary index per CAT scene
    ):
        if real.device != simulated.device:
            raise ValueError(f"the stores lie on {real.device} and {simulated.device}")
        self.cfg = cfg
        self.real = real
        self.simulated = simulated
        self.focal_agent_idx = torch.as_tensor(focal_agent_idx, dtype=torch.long, device=real.device)

    def sample_batch(
        self,
        generator: torch.Generator | None,
        batch_size: int,
        indices: tuple[torch.Tensor, torch.Tensor] | None = None,
        draws: TrainDraws | None = None,
    ) -> dict:
        """A batch of ``batch_size``: round(batch_size x replay_ratio) real
        scenes first, then CAT scenes. ``generator`` draws the scene indices
        and the samples' choices, unless ``indices`` (real, CAT) and
        ``draws`` give them (tests replay the JAX draws through them)."""
        num_real = int(round(batch_size * self.cfg.waymo.replay_ratio))
        num_sim = batch_size - num_real
        if indices is None:
            indices = (self.real.draw_indices(generator, num_real), self.simulated.draw_indices(generator, num_sim))
        idx_real, idx_sim = (torch.as_tensor(i, device=self.real.device).long() for i in indices)
        (real_s, real_o), (sim_s, sim_o) = self.real.take(idx_real), self.simulated.take(idx_sim)
        scen = _concat_scenarios(real_s, sim_s)
        off = OfflineArrays(*(torch.cat([a, b]) for a, b in zip(real_o, sim_o)))
        dev = self.real.device
        focal = torch.cat([torch.full((num_real,), -1, dtype=torch.long, device=dev), self.focal_agent_idx[idx_sim]])
        supervise = torch.cat([torch.zeros(num_real, dtype=torch.bool, device=dev),
                               torch.full((num_sim,), self.cfg.waymo.supervise_focal_agent, device=dev)])
        return build_train_batch(self.cfg, scen, off, generator=generator, draws=draws,
                                 focal_idx=focal, supervise_focal_only=supervise)


def _concat_scenarios(a: Scenario, b: Scenario) -> Scenario:
    """Two stacked scenarios of one device joined along the scene axis."""
    return dataclasses.replace(
        a, name="", **{k: torch.cat([v, getattr(b, k)]) for k, v in _arrays(a, torch.Tensor).items()}
    )
