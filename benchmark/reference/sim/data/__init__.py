"""Scenes as numpy arrays, their torch twin, the transforms, and the offline
replay, batch construction and store of training."""

from benchmark.reference.sim.data.scenario import Scenario, stack_scenarios, to_torch
from benchmark.reference.sim.data.synthetic import synthetic_scenario

__all__ = ["Scenario", "stack_scenarios", "synthetic_scenario", "to_torch"]
