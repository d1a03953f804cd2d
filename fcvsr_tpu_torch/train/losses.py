"""Pixel losses of the two reference recipes (counterpart of
``fcvsr_tpu.train.losses``).

* :func:`charbonnier_sum` - CVSR_train (opt/loss.py:20-31): eps added
  *unsquared* inside the sqrt, summed.
* :func:`charbonnier` - mmedit (losses/pixelwise_loss.py:41-51):
  sqrt(diff^2 + eps) with eps 1e-12, averaged (the FCVSR configs' reduction).
"""

from __future__ import annotations

import torch

__all__ = ["charbonnier_sum", "charbonnier", "LOSSES"]


def charbonnier_sum(pred: torch.Tensor, target: torch.Tensor,
                    eps: float = 1e-4) -> torch.Tensor:
    """sum(sqrt(diff^2 + eps)), eps unsquared."""
    diff = pred - target
    return torch.sqrt(diff * diff + eps).sum()


def charbonnier(pred: torch.Tensor, target: torch.Tensor,
                eps: float = 1e-12) -> torch.Tensor:
    """mean(sqrt(diff^2 + eps))."""
    diff = pred - target
    return torch.sqrt(diff * diff + eps).mean()


# the config's ``train.loss`` names
LOSSES = {"charbonnier_sum": charbonnier_sum, "charbonnier_mean": charbonnier}
