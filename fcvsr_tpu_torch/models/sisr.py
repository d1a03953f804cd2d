"""ESRGAN's residual-in-residual dense blocks (the part of
``fcvsr_tpu.models.sisr`` that GLEAN's encoder needs; the single-image
models stay to be ported).  NHWC, the JAX package's names."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2d

__all__ = ["_DenseBlock", "_RRDB"]


class _DenseBlock(nn.Module):
    """Five densely connected 3x3 convs (leaky relu 0.2 after the first
    four), the last scaled by 0.2 onto the input.  Its convs start
    kaiming-normal x 0.1 with zero bias, as the JAX ``init_scale=0.1``."""

    def __init__(self, mid_channels: int = 64, growth: int = 32):
        super().__init__()
        for i in range(5):
            self.add_module(f"conv{i + 1}", Conv2d(
                mid_channels + i * growth,
                growth if i < 4 else mid_channels, 3))

    def forward(self, x):
        feats = [x]
        for i in range(1, 5):
            feats.append(F.leaky_relu(
                getattr(self, f"conv{i}")(torch.cat(feats, -1)), 0.2))
        return self.conv5(torch.cat(feats, -1)) * 0.2 + x

    @torch.no_grad()
    def init_seeded(self, generator: torch.Generator) -> None:
        for i in range(1, 6):
            conv = getattr(self, f"conv{i}")
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape,
                                          generator=generator)
                              * (2.0 / fan_in) ** 0.5 * 0.1)
            conv.bias.zero_()


class _RRDB(nn.Module):
    """Three dense blocks, scaled by 0.2 onto the input."""

    def __init__(self, mid_channels: int = 64, growth: int = 32):
        super().__init__()
        self.rdb1 = _DenseBlock(mid_channels, growth)
        self.rdb2 = _DenseBlock(mid_channels, growth)
        self.rdb3 = _DenseBlock(mid_channels, growth)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x
