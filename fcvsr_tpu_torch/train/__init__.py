"""Training of the port: losses, schedules, the train state and step, and
the CLI (``python -m fcvsr_tpu_torch.train.cli``)."""

from .losses import charbonnier, charbonnier_sum
from .lr_schedule import build_schedule, cosine_restart, linear_decay, multistep
from .trainer import TrainState, make_train_step

__all__ = ["charbonnier", "charbonnier_sum", "build_schedule",
           "cosine_restart", "linear_decay", "multistep", "TrainState",
           "make_train_step"]
