"""Training: losses, the train / eval steps, checkpoints (the loop is
``training/trainer.py``)."""
from .checkpointing import CheckpointManager, restore_variables
from .losses import (PerceptualLoss, l1_spectrogram_loss, multi_resolution_stft_loss,
                     source_separation_loss)
from .train_state import (TrainState, create_train_state, make_eval_step,
                          make_learning_rate_schedule, make_optimizer,
                          make_sharded_eval_step, make_sharded_train_step, make_train_step)

__all__ = ["CheckpointManager", "PerceptualLoss", "TrainState", "create_train_state",
           "l1_spectrogram_loss", "make_eval_step", "make_learning_rate_schedule",
           "make_optimizer", "make_sharded_eval_step", "make_sharded_train_step",
           "make_train_step", "multi_resolution_stft_loss", "restore_variables",
           "source_separation_loss"]
