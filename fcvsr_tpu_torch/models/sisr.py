"""Single-image SR backbones and TOFlow (counterpart of
``fcvsr_tpu.models.sisr``): EDSR, SRCNN, MSRResNet, RRDBNet (ESRGAN's
generator, whose residual-in-residual dense blocks GLEAN's encoder shares),
RDN and the TOFlow video model.

The models take and return (B, C, H, W) tensors, as the reference API does,
and run channels-last inside.  Module names are the JAX package's (flax's
``Conv_0`` dropped), so ``utils.convert.state_dict_from_jax`` carries its
params.  The pixel-shuffle upsamplers step x3 while the factor divides by
3, else x2.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bicubic, resize_bilinear
from ..ops.warp import flow_warp
from .basicvsr import MMResidualBlock
from .blocks import Conv2d, pixel_shuffle
from .spynet import SpyNet

__all__ = ["EDSR", "SRCNN", "MSRResNet", "RRDBNet", "RDN", "TOFlow",
           "_DenseBlock", "_RRDB"]


def _nchw_in(x):
    return x.permute(0, 2, 3, 1)


def _nchw_out(x):
    return x.permute(0, 3, 1, 2)


def _shuffle_steps(upscale_factor: int):
    """The pixel-shuffle factors, largest first: (the factor left, f)."""
    up, steps = upscale_factor, []
    while up > 1:
        f = 3 if up % 3 == 0 else 2
        steps.append((up, f))
        up //= f
    return steps


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


class _EDSRTrunk(nn.Module):
    """EDSR's features: ``conv_first``, ``num_blocks`` residual blocks
    (``block{i}_conv1``, relu, ``block{i}_conv2``, times ``res_scale``),
    ``conv_after_body``, plus ``conv_first``'s output.  LIIF-EDSR's encoder
    is this trunk."""

    def __init__(self, in_channels: int, mid_channels: int, num_blocks: int,
                 res_scale: float):
        super().__init__()
        mid = mid_channels
        self.num_blocks, self.res_scale = num_blocks, res_scale
        self.conv_first = Conv2d(in_channels, mid, 3)
        for i in range(num_blocks):
            self.add_module(f"block{i}_conv1", Conv2d(mid, mid, 3))
            self.add_module(f"block{i}_conv2", Conv2d(mid, mid, 3))
        self.conv_after_body = Conv2d(mid, mid, 3)

    def features(self, y):
        y = self.conv_first(y)
        res = y
        for i in range(self.num_blocks):
            out = getattr(self, f"block{i}_conv1")(res)
            out = getattr(self, f"block{i}_conv2")(F.relu(out))
            res = res + out * self.res_scale
        return self.conv_after_body(res) + y


class EDSR(_EDSRTrunk):
    """mmedit edsr.py:41-140: the trunk on the mean-shifted input, then
    pixel-shuffle steps (``up{i}``) and ``conv_last``, the mean added
    back."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, num_blocks: int = 16,
                 upscale_factor: int = 4, res_scale: float = 1.0,
                 rgb_mean: Sequence[float] = (0.4488, 0.4371, 0.4040)):
        super().__init__(in_channels, mid_channels, num_blocks, res_scale)
        mid = mid_channels
        self.register_buffer("mean", torch.tensor(tuple(rgb_mean)),
                             persistent=False)
        self.factors = [f for _, f in _shuffle_steps(upscale_factor)]
        for i, f in enumerate(self.factors):
            self.add_module(f"up{i}", Conv2d(mid, mid * f * f, 3))
        self.conv_last = Conv2d(mid, out_channels, 3)

    def forward(self, x):
        mean = self.mean.to(x.dtype)
        y = self.features(_nchw_in(x) - mean)
        for i, f in enumerate(self.factors):
            y = pixel_shuffle(getattr(self, f"up{i}")(y), f)
        return _nchw_out(self.conv_last(y) + mean)


class SRCNN(nn.Module):
    """mmedit srcnn.py: a bicubic pre-upsampling, then 9-1-5 convs."""

    def __init__(self, channels: Sequence[int] = (3, 64, 32, 3),
                 kernel_sizes: Sequence[int] = (9, 1, 5),
                 upscale_factor: int = 4):
        super().__init__()
        self.upscale_factor = upscale_factor
        for i in range(3):
            self.add_module(f"conv{i + 1}", Conv2d(
                channels[i], channels[i + 1], kernel_sizes[i]))

    def forward(self, x):
        y = _nchw_in(x)
        y = resize_bicubic(y, y.shape[1] * self.upscale_factor,
                           y.shape[2] * self.upscale_factor)
        y = F.relu(self.conv1(y))
        y = F.relu(self.conv2(y))
        return _nchw_out(self.conv3(y))


class MSRResNet(nn.Module):
    """mmedit sr_resnet.py: the modified SRResNet (residual blocks without
    BN, pixel-shuffle steps ``up{factor left}`` with leaky relu 0.1) over
    a bilinear base."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, num_blocks: int = 16,
                 upscale_factor: int = 4):
        super().__init__()
        mid = mid_channels
        self.upscale_factor = upscale_factor
        self.conv_first = Conv2d(in_channels, mid, 3)
        for i in range(num_blocks):
            self.add_module(f"block{i}", MMResidualBlock(mid))
        self.num_blocks = num_blocks
        self.steps = _shuffle_steps(upscale_factor)
        for up, f in self.steps:
            self.add_module(f"up{up}", Conv2d(mid, mid * f * f, 3))
        self.conv_hr = Conv2d(mid, 64, 3)
        self.conv_last = Conv2d(64, out_channels, 3)

    def forward(self, x):
        xin = _nchw_in(x)
        res = F.leaky_relu(self.conv_first(xin), 0.1)
        for i in range(self.num_blocks):
            res = getattr(self, f"block{i}")(res)
        for up, f in self.steps:
            res = F.leaky_relu(
                pixel_shuffle(getattr(self, f"up{up}")(res), f), 0.1)
        res = F.leaky_relu(self.conv_hr(res), 0.1)
        res = self.conv_last(res)
        base = resize_bilinear(xin, xin.shape[1] * self.upscale_factor,
                               xin.shape[2] * self.upscale_factor)
        return _nchw_out(res + base)


class RRDBNet(nn.Module):
    """mmedit rrdb_net.py:116+ (ESRGAN's generator): residual-in-residual
    dense blocks, then ``upscale_factor // 2`` steps of a bilinear x2 and a
    conv with leaky relu 0.2, as the JAX package upsamples."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, num_blocks: int = 23,
                 growth_channels: int = 32, upscale_factor: int = 4):
        super().__init__()
        mid = mid_channels
        self.conv_first = Conv2d(in_channels, mid, 3)
        for i in range(num_blocks):
            self.add_module(f"rrdb{i}", _RRDB(mid, growth_channels))
        self.num_blocks = num_blocks
        self.conv_body = Conv2d(mid, mid, 3)
        self.num_ups = upscale_factor // 2
        for i in range(self.num_ups):
            self.add_module(f"up{i}", Conv2d(mid, mid, 3))
        self.conv_hr = Conv2d(mid, mid, 3)
        self.conv_last = Conv2d(mid, out_channels, 3)

    def forward(self, x):
        feat = self.conv_first(_nchw_in(x))
        body = feat
        for i in range(self.num_blocks):
            body = getattr(self, f"rrdb{i}")(body)
        feat = feat + self.conv_body(body)
        for i in range(self.num_ups):
            feat = resize_bilinear(feat, feat.shape[1] * 2, feat.shape[2] * 2)
            feat = F.leaky_relu(getattr(self, f"up{i}")(feat), 0.2)
        feat = F.leaky_relu(self.conv_hr(feat), 0.2)
        return _nchw_out(self.conv_last(feat))


class _RDNTrunk(nn.Module):
    """RDN's features: shallow convs ``sfe1``, ``sfe2``; ``num_blocks``
    residual dense blocks of ``num_layers`` relu convs (``rdb{b}_l{l}``)
    and a 1x1 fusion each (``rdb{b}_lff``); global fusion ``gff1``
    (1x1 over every block's output), ``gff2``; plus ``sfe1``.  LIIF-RDN's
    encoder is this trunk."""

    def __init__(self, in_channels: int, mid_channels: int, num_blocks: int,
                 num_layers: int, channel_growth: int):
        super().__init__()
        mid, g = mid_channels, channel_growth
        self.num_blocks, self.num_layers = num_blocks, num_layers
        self.sfe1 = Conv2d(in_channels, mid, 3)
        self.sfe2 = Conv2d(mid, mid, 3)
        for b in range(num_blocks):
            for li in range(num_layers):
                self.add_module(f"rdb{b}_l{li}", Conv2d(mid + li * g, g, 3))
            self.add_module(f"rdb{b}_lff",
                            Conv2d(mid + num_layers * g, mid, 1))
        self.gff1 = Conv2d(mid * num_blocks, mid, 1)
        self.gff2 = Conv2d(mid, mid, 3)

    def features(self, y):
        sfe1 = self.sfe1(y)
        feats = self.sfe2(sfe1)
        locals_ = []
        for b in range(self.num_blocks):
            cat = [feats]
            for li in range(self.num_layers):
                cat.append(F.relu(
                    getattr(self, f"rdb{b}_l{li}")(torch.cat(cat, -1))))
            feats = feats + getattr(self, f"rdb{b}_lff")(torch.cat(cat, -1))
            locals_.append(feats)
        return self.gff2(self.gff1(torch.cat(locals_, -1))) + sfe1


class RDN(_RDNTrunk):
    """mmedit rdn.py: the residual dense network (16 blocks of 8 layers),
    then pixel-shuffle steps ``up{factor left}`` and the ``output`` conv."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, num_blocks: int = 16,
                 num_layers: int = 8, channel_growth: int = 64,
                 upscale_factor: int = 4):
        super().__init__(in_channels, mid_channels, num_blocks, num_layers,
                         channel_growth)
        mid = mid_channels
        self.steps = _shuffle_steps(upscale_factor)
        for up, f in self.steps:
            self.add_module(f"up{up}", Conv2d(mid, mid * f * f, 3))
        self.output = Conv2d(mid, out_channels, 3)

    def forward(self, x):
        feats = self.features(_nchw_in(x))
        for up, f in self.steps:
            feats = pixel_shuffle(getattr(self, f"up{up}")(feats), f)
        return _nchw_out(self.output(feats))


class TOFlow(nn.Module):
    """mmedit tof.py: task-oriented flow.  SPyNet's flow from the centre
    frame to each neighbour, each neighbour warped onto the centre (zeros
    outside the frame), the 7 frames fused by 9-9-1-1 convs, plus the
    centre.  (B, 7, 3, H, W) at HR (after an external upsampling), H and W
    multiples of 32 -> (B, 3, H, W)."""

    def __init__(self):
        super().__init__()
        self.spynet = SpyNet()
        self.conv_1 = Conv2d(21, 64, 9)
        self.conv_2 = Conv2d(64, 64, 9)
        self.conv_3 = Conv2d(64, 64, 1)
        self.conv_4 = Conv2d(64, 3, 1)

    def forward(self, lrs):
        t = lrs.shape[1]
        x = lrs.permute(0, 1, 3, 4, 2)
        cf = t // 2
        center = x[:, cf]
        warped = []
        for i in range(t):
            if i == cf:
                warped.append(center)
            else:
                flow = self.spynet(center, x[:, i])
                warped.append(flow_warp(x[:, i], flow))
        y = F.relu(self.conv_1(torch.cat(warped, -1)))
        y = F.relu(self.conv_2(y))
        y = F.relu(self.conv_3(y))
        return _nchw_out(self.conv_4(y) + center)
