"""Training state and the train and eval steps (counterpart of
``fcvsr_tpu.train.trainer``), on one device or data-parallel over ranks.

:class:`TrainState` holds the model, Adam (eps 1e-8, as optax's), the
schedule, an optional EMA of the parameters and the number of updates
taken.  Each update sets Adam's lr to ``schedule(step)`` first, so update 0
runs at ``schedule(0)`` as in optax, and the EMA (decay 0.999) follows the
update.

With a process group, :func:`make_train_step` runs the model under
``DistributedDataParallel`` (``parallel.data_parallel``): each rank steps on
its share of the global batch, and the update is the one the JAX package's
mesh step takes on the whole batch, where XLA psums the gradient.  DDP
averages the ranks' gradients, which is the whole batch's gradient of a
loss that averages over the batch (``charbonnier_mean``); a loss that sums
over it (``charbonnier_sum``) is scaled by the world size on each rank
first.  The reported loss is :func:`parallel.psum_metrics`' mean of the
ranks' (scaled) losses: the whole batch's loss.  Adam, the schedule and
the EMA run on every rank on the same averaged gradients, and
``TrainState.model`` stays the unwrapped module, so a checkpoint holds no
``module.`` keys.  :func:`make_eval_step` splits a batch of windows over
the ranks and gathers the outputs in rank order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..parallel import data_parallel, gather, make_mesh, psum_metrics, \
    rank_share
from .losses import LOSSES

__all__ = ["TrainState", "make_train_step", "make_eval_step", "EMA_DECAY",
           "batch_loss_scale"]

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


def batch_loss_scale(loss_type: str, group) -> int:
    """What a rank's loss is multiplied by under DDP, so that the ranks'
    averaged gradient is the whole batch's: the world size for a loss that
    sums over the batch, else 1 (and 1 without a group)."""
    if group is None or loss_type != "charbonnier_sum":
        return 1
    return torch.distributed.get_world_size(group)


def make_train_step(state: TrainState, loss_type: str = "charbonnier_mean",
                    group=None):
    """``step(lrs, gt) -> {"loss": tensor}``: forward, loss, backward and one
    update of ``state``.  lrs: (B, T, C, H, W); gt: (B, C, 4H, 4W), this
    rank's share of the global batch when ``group`` is a process group
    (``torch.distributed.group.WORLD`` for the default one), whose ranks
    then step together (see the module's note)."""
    if loss_type not in LOSSES:
        raise ValueError(f"unknown loss {loss_type}; options: {list(LOSSES)}")
    loss_fn = LOSSES[loss_type]
    forward = state.model if group is None else data_parallel(state.model,
                                                              group)
    scale = batch_loss_scale(loss_type, group)

    def step(lrs: torch.Tensor, gt: torch.Tensor) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(forward(lrs), gt)
        if scale != 1:
            loss = loss * scale
        loss.backward()
        state.apply_gradients()
        if group is None:
            return {"loss": loss.detach()}
        return psum_metrics({"loss": loss}, group)

    return step


def make_eval_step(model: torch.nn.Module, group=None):
    """``step(lrs) -> out``: the model's output without autograd.  With a
    process group, each rank forwards its contiguous share of the batch
    (whose size must be a multiple of the world size) and every rank gets
    the whole output, the shares gathered in rank order."""
    mesh = None if group is None else make_mesh(
        next(model.parameters()).device, group)

    @torch.no_grad()
    def step(lrs: torch.Tensor) -> torch.Tensor:
        if mesh is None:
            return model(lrs)
        return gather(model(rank_share(lrs, mesh)), group).flatten(0, 1)

    return step
