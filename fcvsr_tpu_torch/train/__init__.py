"""Training of the port: losses, schedules, the train state and step, and
the CLI (``python -m fcvsr_tpu_torch.train.cli``)."""

from .losses import (charbonnier, charbonnier_sum, l1_loss, mse_loss,
                     sobel_loss, total_variation)
from .lr_schedule import build_schedule, cosine_restart, linear_decay, multistep
from .trainer import TrainState, make_eval_step, make_train_step

__all__ = ["charbonnier", "charbonnier_sum", "l1_loss", "mse_loss",
           "sobel_loss", "total_variation", "build_schedule",
           "cosine_restart", "linear_decay", "multistep", "TrainState",
           "make_train_step", "make_eval_step"]
