"""SPyNet optical flow (counterpart of ``fcvsr_tpu.models.spynet``).

A 6-level coarse-to-fine pyramid: each level refines the upsampled flow with
five 7x7 convs over [ref, supp border-warped by the flow, the flow].
Parameter names are the reference checkpoint's,
``basic_module.{L}.basic_module.{0,2,4,6,8}.{weight,bias}``, so a reference
``state_dict`` loads with ``load_state_dict(strict=True)`` (the JAX
package's ``convert_spynet_state_dict`` maps it onto its flax names).
:func:`spynet_flow` adds the /32 resize wrapper (``SpyNet_flow``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from ..ops.warp import flow_warp
from .blocks import Conv2d

__all__ = ["SpyNet", "spynet_flow"]

# ImageNet mean and std, applied to [0, 1] RGB
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class _BasicModule(nn.Module):
    def __init__(self):
        super().__init__()
        layers = []
        for cin, cout in ((8, 32), (32, 64), (64, 32), (32, 16)):
            layers += [Conv2d(cin, cout, 7), nn.ReLU()]
        self.basic_module = nn.Sequential(*layers, Conv2d(16, 2, 7))

    def forward(self, x):
        return self.basic_module(x)


def _avg_pool2(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class SpyNet(nn.Module):
    """ref, supp: (B, H, W, 3) in [0, 1], H and W multiples of 32 ->
    the flow (B, H, W, 2), (dx, dy), that warps supp onto ref."""

    def __init__(self, levels: int = 6):
        super().__init__()
        self.basic_module = nn.ModuleList(_BasicModule()
                                          for _ in range(levels))
        self.register_buffer("mean", torch.tensor(_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(_STD), persistent=False)

    def forward(self, ref, supp):
        refs = [(ref - self.mean) / self.std]
        supps = [(supp - self.mean) / self.std]
        for _ in range(len(self.basic_module) - 1):
            refs.insert(0, _avg_pool2(refs[0]))
            supps.insert(0, _avg_pool2(supps[0]))
        b, h0, w0, _ = refs[0].shape
        flow = refs[0].new_zeros((b, h0 // 2, w0 // 2, 2))
        for level, module in enumerate(self.basic_module):
            rh, rw = refs[level].shape[1:3]
            up = resize_bilinear(flow, 2 * flow.shape[1], 2 * flow.shape[2],
                                 align_corners=True) * 2.0
            if up.shape[1] != rh:  # repeat the last row / column
                up = torch.cat([up, up[:, -1:]], 1)
            if up.shape[2] != rw:
                up = torch.cat([up, up[:, :, -1:]], 2)
            warped = flow_warp(supps[level], up, padding_mode="border")
            flow = module(torch.cat([refs[level], warped, up], -1)) + up
        return flow


def spynet_flow(model: SpyNet, ref, supp):
    """Flow of (B, H, W, 3) frames of any size: both resized (bilinear,
    half-pixel) up to multiples of 32, the flow resized back and scaled by
    (w / w32, h / h32)."""
    h, w = ref.shape[1:3]
    h32 = int(math.floor(math.ceil(h / 32.0) * 32.0))
    w32 = int(math.floor(math.ceil(w / 32.0) * 32.0))
    flow = model(resize_bilinear(ref, h32, w32),
                 resize_bilinear(supp, h32, w32))
    flow = resize_bilinear(flow, h, w)
    return flow * flow.new_tensor([w / w32, h / h32])
