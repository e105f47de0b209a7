"""Evaluation: closed-loop policy metrics (Table 1), planner-vs-adversary
metrics and the CAT adversarial-trajectory helpers."""

from ctrl_sim_tpu_torch.evals.metrics import compute_policy_metrics

__all__ = ["compute_policy_metrics"]
