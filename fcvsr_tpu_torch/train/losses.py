"""Pixel losses of the two reference recipes (counterpart of
``fcvsr_tpu.train.losses``).

* :func:`charbonnier_sum` - CVSR_train (opt/loss.py:20-31): eps added
  *unsquared* inside the sqrt, summed.
* :func:`charbonnier` - mmedit (losses/pixelwise_loss.py:41-51):
  sqrt(diff^2 + eps) with eps 1e-12, averaged by default (the FCVSR
  configs' reduction), summed or kept whole, times ``loss_weight``.
* :func:`l1_loss`, :func:`mse_loss`, :func:`total_variation`,
  :func:`sobel_loss` - the rest of opt/loss.py, which ablations use.

``LOSSES`` here holds the config's ``train.loss`` names; the registry of
the mmedit names is ``models.registry.LOSSES``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["charbonnier_sum", "charbonnier", "l1_loss", "mse_loss",
           "total_variation", "sobel_loss", "LOSSES"]


def charbonnier_sum(pred: torch.Tensor, target: torch.Tensor,
                    eps: float = 1e-4) -> torch.Tensor:
    """sum(sqrt(diff^2 + eps)), eps unsquared."""
    diff = pred - target
    return torch.sqrt(diff * diff + eps).sum()


def charbonnier(pred: torch.Tensor, target: torch.Tensor,
                eps: float = 1e-12, reduction: str = "mean",
                loss_weight: float = 1.0) -> torch.Tensor:
    """sqrt(diff^2 + eps), reduced by ``reduction`` ('mean', 'sum' or
    'none'), times ``loss_weight``."""
    diff = pred - target
    val = torch.sqrt(diff * diff + eps)
    if reduction == "mean":
        out = val.mean()
    elif reduction == "sum":
        out = val.sum()
    elif reduction == "none":
        out = val
    else:
        raise ValueError(f"unknown reduction {reduction}")
    return loss_weight * out


def l1_loss(pred, target, reduction: str = "mean"):
    val = (pred - target).abs()
    return val.mean() if reduction == "mean" else val.sum()


def mse_loss(pred, target, reduction: str = "mean"):
    val = (pred - target).square()
    return val.mean() if reduction == "mean" else val.sum()


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV over the trailing two spatial axes of (..., H, W)."""
    dh = (x[..., 1:, :] - x[..., :-1, :]).abs()
    dw = (x[..., :, 1:] - x[..., :, :-1]).abs()
    return dh.mean() + dw.mean()


def sobel_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between Sobel gradient magnitudes, (B, C, H, W) layout; the taps
    are a fixed correlation with zero padding."""
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      dtype=pred.dtype, device=pred.device)
    taps = torch.stack([kx, kx.t()])[:, None]          # (2, 1, 3, 3)

    def grad(img):
        b, c, h, w = img.shape
        g = F.conv2d(img.reshape(b * c, 1, h, w), taps, padding=1)
        return torch.sqrt(g[:, 0] ** 2 + g[:, 1] ** 2 + 1e-12).reshape(
            b, c, h, w)

    return (grad(pred) - grad(target)).abs().mean()


# the config's ``train.loss`` names
LOSSES = {"charbonnier_sum": charbonnier_sum, "charbonnier_mean": charbonnier}
