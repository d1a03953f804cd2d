"""RealBasicVSR (counterpart of ``fcvsr_tpu.models.real_basicvsr``; mmedit
sr_backbones/real_basicvsr_net.py, with mmedit's parameter names).

An image-cleaning module (residual blocks and a conv that predict a
residue) runs up to three times over every frame, stopping once the mean
|residue| falls below ``dynamic_refine_thres`` / 255; then BasicVSR
restores the cleaned clip.  The JAX package gates the second and third
passes with ``lax.cond`` inside one compiled program; here the stop is a
Python branch on the residue's mean, read on the host after each pass.
Both give the same output and the same gradient on either side of the
threshold (the passes not taken contribute nothing to either).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .basicvsr import BasicVSRNet, MMResidualBlocksWithInputConv
from .blocks import Conv2d

__all__ = ["RealBasicVSRNet"]


class RealBasicVSRNet(nn.Module):
    """(B, T, 3, H, W) in [0, 1] -> (B, T, 3, 4H, 4W), and the cleaned
    frames (B, T, 3, H, W) with ``return_lqs``.  H and W are multiples of
    32 (BasicVSR's SPyNet).  ``dynamic_refine_thres`` is in 0-255 units."""

    def __init__(self, mid_channels: int = 64,
                 num_propagation_blocks: int = 20,
                 num_cleaning_blocks: int = 20,
                 dynamic_refine_thres: float = 255.0):
        super().__init__()
        self.dynamic_refine_thres = dynamic_refine_thres
        self.image_cleaning = nn.Sequential(
            MMResidualBlocksWithInputConv(3, mid_channels,
                                          num_cleaning_blocks),
            Conv2d(mid_channels, 3, 3))
        self.basicvsr = BasicVSRNet(mid_channels, num_propagation_blocks)
        self.cleaning_passes = 0   # the last forward's

    def forward(self, lqs, return_lqs: bool = False):
        n, t, c, h, w = lqs.shape
        thres = self.dynamic_refine_thres / 255.0
        frames = lqs.permute(0, 1, 3, 4, 2).reshape(n * t, h, w, c)
        for k in range(3):
            residues = self.image_cleaning(frames)
            frames = frames + residues
            self.cleaning_passes = k + 1
            if not bool(residues.abs().mean() >= thres):
                break
        cleaned = frames.reshape(n, t, h, w, c).permute(0, 1, 4, 2, 3)
        out = self.basicvsr(cleaned)
        return (out, cleaned) if return_lqs else out
