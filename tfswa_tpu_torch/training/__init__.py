"""Training: losses, the train / eval steps, checkpoints (the loop is
``training/trainer.py``)."""
from .checkpointing import CheckpointManager, restore_variables
from .losses import l1_spectrogram_loss, source_separation_loss
from .train_state import (TrainState, create_train_state, make_eval_step,
                          make_learning_rate_schedule, make_optimizer, make_train_step)

__all__ = ["CheckpointManager", "TrainState", "create_train_state", "l1_spectrogram_loss",
           "make_eval_step", "make_learning_rate_schedule", "make_optimizer",
           "make_train_step", "restore_variables", "source_separation_loss"]
