"""BasicVSR (counterpart of ``fcvsr_tpu.models.basicvsr``) and the mmedit /
mmcv building blocks of the zoo, with mmedit's parameter names.

``BasicVSRNet`` is mmedit's BasicVSRNet: SPyNet flows between neighbours,
a backward and a forward recurrent propagation (the feature carried from
frame to frame is warped by the flow, joined with the frame and run
through a residual trunk), and pixel-shuffle upsampling over a bilinear
x4 base.  Time runs as a Python loop where the JAX package scans;
SPyNet runs at the input's size (without mmedit's /32 resize), so H and W
are multiples of 32, as in both packages' BasicVSR++.

``MMResidualBlock`` is mmedit's ResidualBlockNoBN,
``MMResidualBlocksWithInputConv`` its ResidualBlocksWithInputConv,
``MMPixelShufflePack`` its PixelShufflePack, ``ConvModule`` mmcv's conv +
leaky relu 0.1, and ``ModulatedDeformConv2d`` mmcv's deformable conv
(DCNv2, or DCNv1 without a mask and a bias), whose forward is the DCN
kernel of ``ops.fused_dcn``.  Modules take and return channels-last (B, H,
W, C) tensors.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_dcn import modulated_deform_conv2d_fused
from ..ops.resize import resize_bilinear
from ..ops.warp import flow_warp
from .blocks import Conv2d, pixel_shuffle
from .scnet_rows import conv_bias, hwio
from .spynet import SpyNet

__all__ = ["BasicVSRNet", "ConvModule", "MMResidualBlock",
           "MMResidualBlocksWithInputConv", "MMPixelShufflePack",
           "ModulatedDeformConv2d"]


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
    ``bias`` (None with ``bias=False``) as mmcv keeps them.  Subclasses add
    the ``conv_offset`` that predicts offsets (and mask); its last conv is
    zero-initialised (``init_weights``).  With ``mask=None`` it is DCNv1."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int, bias: bool = True):
        super().__init__()
        self.deform_groups = deform_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x, offset, mask):
        return modulated_deform_conv2d_fused(
            x.contiguous(), offset.contiguous(),
            None if mask is None else mask.contiguous(), hwio(self),
            conv_bias(self), deform_groups=self.deform_groups)


class BasicVSRNet(nn.Module):
    """(B, T, 3, H, W) in [0, 1] -> (B, T, 3, 4H, 4W); H and W multiples of
    32.  The defaults are mmedit's basicvsr_reds4 (64 channels, 30 residual
    blocks a direction)."""

    def __init__(self, mid_channels: int = 64, num_blocks: int = 30):
        super().__init__()
        mid = mid_channels
        self.mid_channels = mid
        self.spynet = SpyNet()
        self.backward_resblocks = MMResidualBlocksWithInputConv(
            mid + 3, mid, num_blocks)
        self.forward_resblocks = MMResidualBlocksWithInputConv(
            mid + 3, mid, num_blocks)
        self.fusion = Conv2d(2 * mid, mid, 1)
        self.upsample1 = MMPixelShufflePack(mid, mid, 2, 3)
        self.upsample2 = MMPixelShufflePack(mid, 64, 2, 3)
        self.conv_hr = Conv2d(64, 64, 3)
        self.conv_last = Conv2d(64, 3, 3)

    def forward(self, lrs):
        b, t, c, h, w = lrs.shape
        x = lrs.permute(0, 1, 3, 4, 2)                      # (B, T, H, W, C)
        ref = x[:, :-1].reshape(b * (t - 1), h, w, c)
        supp = x[:, 1:].reshape(b * (t - 1), h, w, c)
        flows_backward = self.spynet(ref, supp).reshape(b, t - 1, h, w, 2)
        flows_forward = self.spynet(supp, ref).reshape(b, t - 1, h, w, 2)

        feat_prop = x.new_zeros((b, h, w, self.mid_channels))
        outs_b = [None] * t
        for i in range(t - 1, -1, -1):
            if i < t - 1:
                feat_prop = flow_warp(feat_prop, flows_backward[:, i])
            feat_prop = self.backward_resblocks(
                torch.cat([x[:, i], feat_prop], -1))
            outs_b[i] = feat_prop
        feat_prop = torch.zeros_like(feat_prop)
        outs_f = []
        for i in range(t):
            if i > 0:
                feat_prop = flow_warp(feat_prop, flows_forward[:, i - 1])
            feat_prop = self.forward_resblocks(
                torch.cat([x[:, i], feat_prop], -1))
            outs_f.append(feat_prop)

        # the upsampling of every frame as one batch
        feats = torch.cat([torch.stack(outs_b, 1), torch.stack(outs_f, 1)],
                          -1).reshape(b * t, h, w, 2 * self.mid_channels)
        out = F.leaky_relu(self.fusion(feats), 0.1)
        out = F.leaky_relu(self.upsample1(out), 0.1)
        out = F.leaky_relu(self.upsample2(out), 0.1)
        out = self.conv_last(F.leaky_relu(self.conv_hr(out), 0.1))
        out = out + resize_bilinear(x.reshape(b * t, h, w, c), 4 * h, 4 * w)
        return out.reshape(b, t, 4 * h, 4 * w, c).permute(0, 1, 4, 2, 3)
