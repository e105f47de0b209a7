"""Scenes as numpy arrays, their torch twin, the transforms, and the offline
replay, batch construction and store of training."""

from ctrl_sim_tpu_torch.data.scenario import Scenario, stack_scenarios, to_torch
from ctrl_sim_tpu_torch.data.synthetic import synthetic_scenario

__all__ = ["Scenario", "stack_scenarios", "synthetic_scenario", "to_torch"]
