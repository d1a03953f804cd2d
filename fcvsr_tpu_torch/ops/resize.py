"""Bilinear and bicubic resizes (counterpart of ``fcvsr_tpu.ops.resize``).

The JAX op writes each resize as two matmuls with weights it builds itself;
here ``F.interpolate`` computes the same torch conventions directly.  Public
functions take channels-last (..., H, W, C) tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear", "resize_bicubic", "upsample2x_bilinear",
           "downsample2x_bilinear"]


def _nchw(fn, x: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-3]
    y = fn(x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2))
    y = y.permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize to (out_h, out_w): half-pixel centres by default, or
    endpoint-aligned with ``align_corners=True`` (SPyNet's flow upsampling)."""
    if tuple(x.shape[-3:-1]) == (out_h, out_w):
        return x
    return _nchw(lambda v: F.interpolate(
        v, size=(out_h, out_w), mode="bilinear", align_corners=align_corners),
        x)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic resize to (out_h, out_w): Keys' cubic with a = -0.75,
    half-pixel centres, taps clamped at the edges, no antialias (downward
    too), torch ``size=`` mode."""
    if tuple(x.shape[-3:-1]) == (out_h, out_w):
        return x
    return _nchw(lambda v: F.interpolate(
        v, size=(out_h, out_w), mode="bicubic", align_corners=False), x)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """torch ``scale_factor=2`` bilinear upsample."""
    return _nchw(lambda v: F.interpolate(
        v, scale_factor=2.0, mode="bilinear", align_corners=False), x)


def downsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """torch ``scale_factor=0.5`` bilinear downsample: floored size, literal
    scale 2.0 even for odd inputs."""
    return _nchw(lambda v: F.interpolate(
        v, scale_factor=0.5, mode="bilinear", align_corners=False), x)
