"""Training: losses and the train / eval steps."""
from .losses import l1_spectrogram_loss, source_separation_loss
from .train_state import (TrainState, create_train_state, make_eval_step,
                          make_learning_rate_schedule, make_optimizer, make_train_step)

__all__ = ["TrainState", "create_train_state", "l1_spectrogram_loss",
           "make_eval_step", "make_learning_rate_schedule", "make_optimizer",
           "make_train_step", "source_separation_loss"]
