"""Training: optimizer, train step with accumulation, checkpointing."""

from ctrl_sim_tpu_torch.training.trainer import CTGTrainer, TrainState, Trainer, make_optimizer, trainer_for

__all__ = ["CTGTrainer", "TrainState", "Trainer", "make_optimizer", "trainer_for"]
