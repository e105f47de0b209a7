"""Shared utilities: profiling/metering and experiment logging."""

from ctrl_sim_tpu_torch.utils.profiling import StepMeter, trace_annotation

__all__ = ["StepMeter", "trace_annotation"]
