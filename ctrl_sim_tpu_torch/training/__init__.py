"""Training: optimizer, train step with accumulation, checkpointing."""

from ctrl_sim_tpu_torch.training.trainer import TrainState, Trainer, make_optimizer

__all__ = ["TrainState", "Trainer", "make_optimizer"]
