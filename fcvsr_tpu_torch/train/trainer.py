"""Training state and step (counterpart of ``fcvsr_tpu.train.trainer``, on
one device).

:class:`TrainState` holds the model, Adam (eps 1e-8, as optax's), the
schedule, an optional EMA of the parameters and the number of updates
taken.  Each update sets Adam's lr to ``schedule(step)`` first, so update 0
runs at ``schedule(0)`` as in optax, and the EMA (decay 0.999) follows the
update.  Data parallelism is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .losses import LOSSES

__all__ = ["TrainState", "make_train_step", "EMA_DECAY"]

EMA_DECAY = 0.999


class TrainState:
    """Model, optimizer, schedule, EMA and step of one training run."""

    def __init__(self, model: torch.nn.Module, schedule: Callable[[int], float],
                 betas=(0.9, 0.99), use_ema: bool = False):
        self.model = model
        self.schedule = schedule
        self.step = 0
        self.optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                          betas=tuple(betas), eps=1e-8)
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if use_ema:
            self.ema = {n: p.detach().clone()
                        for n, p in model.named_parameters()}

    def apply_gradients(self) -> None:
        """One Adam update from the gradients in ``.grad``, then the EMA."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        if self.ema is not None:
            with torch.no_grad():
                for n, p in self.model.named_parameters():
                    self.ema[n].mul_(EMA_DECAY).add_((1 - EMA_DECAY) * p)
        self.step += 1

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema": self.ema, "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.ema is not None:
            src = sd["ema"] if sd["ema"] is not None else \
                dict(self.model.named_parameters())
            self.ema = {n: src[n].detach().clone().to(p.device)
                        for n, p in self.model.named_parameters()}
        self.step = int(sd["step"])


def make_train_step(state: TrainState, loss_type: str = "charbonnier_mean"):
    """``step(lrs, gt) -> {"loss": tensor}``: forward, loss, backward and one
    update of ``state``.  lrs: (B, T, C, H, W); gt: (B, C, 4H, 4W)."""
    if loss_type not in LOSSES:
        raise ValueError(f"unknown loss {loss_type}; options: {list(LOSSES)}")
    loss_fn = LOSSES[loss_type]

    def step(lrs: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model(lrs), gt)
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach()}

    return step
