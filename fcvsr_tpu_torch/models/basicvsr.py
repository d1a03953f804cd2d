"""mmedit / mmcv building blocks of the zoo (counterpart of the blocks of
``fcvsr_tpu.models.basicvsr``).

``MMResidualBlock`` is mmedit's ResidualBlockNoBN, ``MMResidualBlocksWith
InputConv`` its ResidualBlocksWithInputConv, ``MMPixelShufflePack`` its
PixelShufflePack, ``ConvModule`` mmcv's conv + leaky relu 0.1, and
``ModulatedDeformConv2d`` mmcv's deformable conv, whose forward is the DCN
kernel of ``ops.fused_dcn``; parameter names are mmedit's.  Modules take and
return channels-last (B, H, W, C) tensors.  ``BasicVSRNet`` itself is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_dcn import modulated_deform_conv2d_fused
from .blocks import Conv2d, pixel_shuffle
from .scnet_rows import conv_bias, hwio

__all__ = ["ConvModule", "MMResidualBlock", "MMResidualBlocksWithInputConv",
           "MMPixelShufflePack", "ModulatedDeformConv2d"]


class ConvModule(nn.Module):
    """mmcv ConvModule: a conv, then leaky relu 0.1 unless ``act`` is
    False."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride)
        self.act = act

    def forward(self, x):
        y = self.conv(x)
        return F.leaky_relu(y, 0.1) if self.act else y


class MMResidualBlock(nn.Module):
    """conv - relu - conv, plus the input.  The reference initialises its
    convs kaiming-normal x 0.1 (``init_weights``)."""

    def __init__(self, mid_channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(mid_channels, mid_channels, 3)
        self.conv2 = Conv2d(mid_channels, mid_channels, 3)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class MMResidualBlocksWithInputConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 64,
                 num_blocks: int = 30):
        super().__init__()
        self.main = nn.Sequential(
            Conv2d(in_channels, out_channels, 3), nn.LeakyReLU(0.1),
            nn.Sequential(*[MMResidualBlock(out_channels)
                            for _ in range(num_blocks)]))

    def forward(self, x):
        return self.main(x)


class MMPixelShufflePack(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 2, upsample_kernel: int = 3):
        super().__init__()
        self.scale_factor = scale_factor
        self.upsample_conv = Conv2d(in_channels,
                                    out_channels * scale_factor ** 2,
                                    upsample_kernel)

    def forward(self, x):
        return pixel_shuffle(self.upsample_conv(x), self.scale_factor)


class ModulatedDeformConv2d(nn.Module):
    """3x3 DCNv2 with ``deform_groups``: ``weight`` (Cout, Cin, 3, 3) and
    ``bias`` as mmcv keeps them.  Subclasses add the ``conv_offset`` that
    predicts offsets and mask; its last conv is zero-initialised
    (``init_weights``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int):
        super().__init__()
        self.deform_groups = deform_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, offset, mask):
        return modulated_deform_conv2d_fused(
            x.contiguous(), offset.contiguous(), mask.contiguous(), hwio(self),
            conv_bias(self), deform_groups=self.deform_groups)
