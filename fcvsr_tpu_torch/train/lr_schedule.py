"""Learning-rate schedules of the reference recipes, as functions of the
number of updates already taken (counterpart of
``fcvsr_tpu.train.lr_schedule``, which builds them for optax).

optax evaluates a schedule at the update count before its increment, so
update 0 uses ``schedule(0)``; :class:`~fcvsr_tpu_torch.train.trainer.
TrainState` sets Adam's lr the same way before each update.

* :func:`multistep` - CVSR_train: MultiStepLR, milestones [2000, 6000,
  10000, 120000], gamma 0.25; the lr drops at the milestone itself, as
  ``optax.piecewise_constant_schedule`` does.
* :func:`cosine_restart` - the mmedit FCVSR configs' CosineRestart.
* :func:`linear_decay` - mmedit's LinearLrUpdaterHook.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = ["multistep", "cosine_restart", "linear_decay", "build_schedule"]

Schedule = Callable[[int], float]


def multistep(base_lr: float, milestones: Sequence[int],
              gamma: float = 0.25) -> Schedule:
    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= int(m) for m in milestones)

    return schedule


def cosine_restart(base_lr: float, periods: Sequence[int],
                   restart_weights: Sequence[float] = (1.0,),
                   min_lr: float = 1e-7) -> Schedule:
    """mmcv CosineRestartLrUpdaterHook: within period i,
    lr = min_lr + (base_lr*w_i - min_lr) * 0.5*(1 + cos(pi * t/T_i));
    min_lr after the last period."""
    if len(periods) != len(restart_weights):
        raise ValueError("one restart weight per period")

    def schedule(step: int) -> float:
        start = 0
        for period, weight in zip(periods, restart_weights):
            if start <= step < start + period:
                t = (step - start) / period
                return min_lr + (base_lr * weight - min_lr) * 0.5 * (
                    1 + math.cos(math.pi * t))
            start += period
        return min_lr

    return schedule


def linear_decay(base_lr: float, total_steps: int,
                 min_ratio: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        frac = min(max(step / total_steps, 0.0), 1.0)
        return base_lr * (1 - (1 - min_ratio) * frac)

    return schedule


def build_schedule(train_cfg) -> Schedule:
    """The schedule a config's ``train`` section names."""
    t = train_cfg
    if t.schedule == "cosine_restart":
        return cosine_restart(t.lr, [t.total_iters], [1.0], t.min_lr)
    if t.schedule == "multistep":
        return multistep(t.lr, t.milestones, t.gamma)
    if t.schedule == "linear":
        return linear_decay(t.lr, t.total_iters)
    raise ValueError(f"unknown schedule {t.schedule}")
