"""DIC, deep face super-resolution with iterative landmark collaboration
(counterpart of ``fcvsr_tpu.models.dic``; mmedit sr_backbones/dic_net.py
and extractors/feedback_hour_glass.py, with the JAX package's parameter
names).  Channels-last inside, NCHW at the boundary.

The feedback recurrence runs ``num_steps`` times inside one forward: each
step's SR feeds the hourglass, whose landmark heatmaps (reduced to five
face parts) steer the next step's feature fusion.

``ConvTranspose2d`` is the JAX package's transposed conv: an lhs-dilated
*correlation* with an HWIO kernel that is not flipped.  Here it is
``F.conv_transpose2d``, whose (Cin, Cout, k, k) weight is that kernel
flipped in both spatial axes, ``W[ci, co, i, j] = K[k-1-i, k-1-j, ci,
co]``; :mod:`..utils.convert` does the flip.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from .blocks import Conv2d, PReLU

__all__ = ["DICNet", "FeedbackHourglass", "reduce_to_five_heatmaps",
           "ConvTranspose2d"]


def _max_pool2(x):
    """2x2 stride-2 max pool of NHWC ``x`` (floor)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class ConvTranspose2d(nn.Module):
    """torch's transposed conv on NHWC tensors: out = (in - 1) stride - 2
    padding + k.  ``weight`` (Cin, Cout, k, k)."""

    def __init__(self, cin: int, features: int, kernel_size: int,
                 stride: int, padding: int):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(cin, features, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                               self.stride, self.padding)
        return y.permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_seeded(self, generator: torch.Generator) -> None:
        # the JAX package's variance_scaling(1/3, fan_in, uniform) over the
        # (k, k, cin) fan-in: U(+-1/sqrt(fan_in))
        cin, _, k, _ = self.weight.shape
        bound = (cin * k * k) ** -0.5
        self.weight.copy_((torch.rand(self.weight.shape, generator=generator)
                           * 2 - 1) * bound)
        self.bias.zero_()


class _HGResBlock(nn.Module):
    """The hourglass's bottleneck residual block (1x1, relu, 3x3, 1x1), a
    1x1 skip when the channels change."""

    def __init__(self, cin: int, out_channels: int):
        super().__init__()
        c = out_channels
        self.conv0 = Conv2d(cin, c // 2, 1)
        self.conv1 = Conv2d(c // 2, c // 2, 3)
        self.conv2 = Conv2d(c // 2, c, 1)
        self.skip = Conv2d(cin, c, 1) if cin != c else None

    def forward(self, x):
        r = self.conv2(self.conv1(F.relu(self.conv0(x))))
        return (x if self.skip is None else self.skip(x)) + r


class _Hourglass(nn.Module):
    """The recursive hourglass: a residual branch at this scale, and a
    max-pooled branch through the next depth, upsampled (bilinear, corners
    aligned) and added."""

    def __init__(self, depth: int, mid_channels: int):
        super().__init__()
        c = mid_channels
        self.up1 = _HGResBlock(c, c)
        self.low1 = _HGResBlock(c, c)
        self.low2 = _HGResBlock(c, c) if depth == 1 else \
            _Hourglass(depth - 1, c)
        self.low3 = _HGResBlock(c, c)

    def forward(self, x):
        up1 = self.up1(x)
        low3 = self.low3(self.low2(self.low1(_max_pool2(x))))
        h, w = low3.shape[1:3]
        return up1 + resize_bilinear(low3, 2 * h, 2 * w, align_corners=True)


class FeedbackHourglass(nn.Module):
    """Landmark heatmaps with feedback: (B, H, W, 3) SR and the last
    hidden state (None at the first step) -> (heatmaps (B, H/4, W/4, N),
    hidden)."""

    def __init__(self, mid_channels: int = 256, num_keypoints: int = 68):
        super().__init__()
        c = mid_channels
        self.pre0 = Conv2d(3, c // 4, 7, 2)
        self.pre1 = _HGResBlock(c // 4, c // 2)
        self.pre2 = _HGResBlock(c // 2, c // 2)
        self.pre3 = _HGResBlock(c // 2, c)
        self.first_conv = Conv2d(2 * c, 2 * c, 1)
        self.hg = _Hourglass(4, 2 * c)
        self.last0 = _HGResBlock(c, c)
        self.last1 = Conv2d(c, c, 1)
        self.last2 = Conv2d(c, num_keypoints, 1)
        self.c = c

    def forward(self, x, last_hidden=None):
        f = self.pre1(F.relu(self.pre0(x)))
        f = self.pre3(self.pre2(_max_pool2(f)))
        hidden = f if last_hidden is None else last_hidden
        f = self.hg(self.first_conv(torch.cat([f, hidden], -1)))
        first, second = f[..., :self.c], f[..., self.c:]
        hm = F.relu(self.last1(self.last0(first)))
        return self.last2(hm), second


def reduce_to_five_heatmaps(heatmap: torch.Tensor,
                            detach: bool = False) -> torch.Tensor:
    """(B, H, W, N) landmark heatmaps, N 5, 68 or 194 -> (B, H, W, 5) face
    parts (eyes, nose, mouth, contour), each map over its max (at least
    0.05)."""
    m = heatmap.amax((1, 2), keepdim=True)
    heatmap = heatmap / torch.clamp(m, min=0.05)
    n = heatmap.shape[-1]
    if n == 5:
        out = heatmap
    elif n == 68:
        parts = [range(36, 42), range(42, 48), range(27, 36), range(48, 68),
                 range(0, 27)]
        out = torch.stack([heatmap[..., p.start:p.stop].sum(-1)
                           for p in parts], -1)
    elif n == 194:
        idx0 = list(range(134, 153)) + list(range(174, 193))
        idx1 = list(range(114, 133)) + list(range(154, 173))
        out = torch.stack([heatmap[..., idx0].sum(-1),
                           heatmap[..., idx1].sum(-1),
                           heatmap[..., 41:57].sum(-1),
                           heatmap[..., 58:113].sum(-1),
                           heatmap[..., 0:40].sum(-1)], -1)
    else:
        raise NotImplementedError(f"landmark count {n} not supported")
    return out.detach() if detach else out


class _FeatureHeatmapFusing(nn.Module):
    """Per-face-part features (group convs, a residual body) weighted by
    the softmax over the five heatmaps and summed."""

    def __init__(self, in_channels: int, num_heatmaps: int, num_blocks: int):
        super().__init__()
        c, nh = in_channels, num_heatmaps
        self.nh, self.c, self.num_blocks = nh, c, num_blocks
        self.conv_first = Conv2d(c, c * nh, 1)
        for i in range(num_blocks):
            self.add_module(f"body{i}_0", Conv2d(c * nh, c * nh, 3,
                                                 groups=nh))
            self.add_module(f"body{i}_1", Conv2d(c * nh, c * nh, 3,
                                                 groups=nh))

    def forward(self, feature, heatmap):
        f = F.leaky_relu(self.conv_first(feature), 0.2)
        for i in range(self.num_blocks):
            r = F.leaky_relu(getattr(self, f"body{i}_0")(f), 0.2)
            f = f + getattr(self, f"body{i}_1")(r)
        attn = torch.softmax(heatmap, -1)                 # (B, H, W, nh)
        b, h, w, _ = f.shape
        return (f.reshape(b, h, w, self.nh, self.c) * attn[..., None]).sum(3)


class _FeedbackBlock(nn.Module):
    """The up / down projection ladder: ``num_blocks`` transposed convs up
    (stride ``upscale_factor``, k + 4, padding 2) and strided convs back
    down, each fed the 1x1 fusion of all before it.  ``custom`` is the
    first step's variant (no hidden state); ``num_heatmaps`` switches on
    the heatmap fusion."""

    def __init__(self, mid_channels: int, num_blocks: int,
                 upscale_factor: int, custom: bool = False,
                 num_heatmaps: int = 0, num_fusion_blocks: int = 0,
                 prelu_init: float = 0.2):
        super().__init__()
        c, s = mid_channels, upscale_factor
        k = upscale_factor + 4
        self.custom, self.num_blocks = custom, num_blocks
        self.conv_first = Conv2d(c if custom else 2 * c, c, 1)
        self.conv_first_act = PReLU(init=prelu_init)
        self.fusion_block = _FeatureHeatmapFusing(
            c, num_heatmaps, num_fusion_blocks) if num_heatmaps else None
        for idx in range(num_blocks):
            if idx > 0:
                self.add_module(f"lr_block{idx - 1}",
                                Conv2d(c * (idx + 1), c, 1))
                self.add_module(f"lr_act{idx - 1}", PReLU(init=prelu_init))
                self.add_module(f"hr_block{idx - 1}",
                                Conv2d(c * (idx + 1), c, 1))
                self.add_module(f"hr_act{idx - 1}", PReLU(init=prelu_init))
            self.add_module(f"up_block{idx}", ConvTranspose2d(c, c, k, s, 2))
            self.add_module(f"up_act{idx}", PReLU(init=prelu_init))
            self.add_module(f"down_block{idx}", _StridedConv(c, k, s, 2))
            self.add_module(f"down_act{idx}", PReLU(init=prelu_init))
        self.conv_last = Conv2d(c * num_blocks, c, 1)
        self.conv_last_act = PReLU(init=prelu_init)

    def forward(self, x, hidden=None, heatmap=None):
        if not self.custom:
            x = torch.cat([x, hidden], -1)
        x = self.conv_first_act(self.conv_first(x))
        if self.fusion_block is not None:
            x = self.fusion_block(x, heatmap)
        lr_features, hr_features = [x], []
        for idx in range(self.num_blocks):
            lr = torch.cat(lr_features, -1)
            if idx > 0:
                lr = getattr(self, f"lr_act{idx - 1}")(
                    getattr(self, f"lr_block{idx - 1}")(lr))
            hr = getattr(self, f"up_act{idx}")(
                getattr(self, f"up_block{idx}")(lr))
            hr_features.append(hr)
            hr = torch.cat(hr_features, -1)
            if idx > 0:
                hr = getattr(self, f"hr_act{idx - 1}")(
                    getattr(self, f"hr_block{idx - 1}")(hr))
            lr = getattr(self, f"down_act{idx}")(
                getattr(self, f"down_block{idx}")(hr))
            lr_features.append(lr)
        out = self.conv_last(torch.cat(lr_features[1:], -1))
        return self.conv_last_act(out)


class _StridedConv(nn.Module):
    """torch's Conv2d(c, c, k, stride, padding) as the JAX package writes
    it: explicit padding, then an unpadded strided conv (``conv``)."""

    def __init__(self, c: int, kernel_size: int, stride: int, padding: int):
        super().__init__()
        self.conv = Conv2d(c, c, kernel_size, stride, padding=padding)

    def forward(self, x):
        return self.conv(x)


class DICNet(nn.Module):
    """(B, 3, 16, 16) face LR -> ([sr_0 .. sr_{n-1}] each (B, 3, 128, 128),
    [heatmap_0 .. heatmap_{n-1}] each (B, N, 32, 32)), one of each a
    feedback step; 8x up."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, num_blocks: int = 6,
                 hg_mid_channels: int = 256, hg_num_keypoints: int = 68,
                 num_steps: int = 4, upscale_factor: int = 8,
                 detach_attention: bool = False, prelu_init: float = 0.2,
                 num_heatmaps: int = 5, num_fusion_blocks: int = 7):
        super().__init__()
        c = mid_channels
        self.c, self.num_steps = c, num_steps
        self.detach_attention, self.prelu_init = detach_attention, prelu_init
        self.conv_first = Conv2d(in_channels, c * 4, 3)
        self.conv_first_act = PReLU(init=prelu_init)
        self.first_block = _FeedbackBlock(c, num_blocks, upscale_factor,
                                          custom=True, prelu_init=prelu_init)
        self.block = _FeedbackBlock(c, num_blocks, upscale_factor,
                                    num_heatmaps=num_heatmaps,
                                    num_fusion_blocks=num_fusion_blocks,
                                    prelu_init=prelu_init)
        self.hour_glass = FeedbackHourglass(hg_mid_channels, hg_num_keypoints)
        self.conv_up = ConvTranspose2d(c, c, 8, 4, 2)
        self.conv_up_act = PReLU(init=prelu_init)
        self.conv_out = Conv2d(c, out_channels, 3)

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        c = self.c
        inter_res = resize_bilinear(x, 128, 128)
        f = self.conv_first_act(self.conv_first(x))
        # depth-to-space with the channels ordered (2, 2, c), as the JAX
        # package reshapes them
        b, h, w, _ = f.shape
        f = f.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        f = f.reshape(b, h * 2, w * 2, c)

        sr_outputs, heatmap_outputs = [], []
        hidden = hg_hidden = heatmap = None
        for step in range(self.num_steps):
            if step == 0:
                feat = self.first_block(f)
            else:
                hm5 = reduce_to_five_heatmaps(heatmap, self.detach_attention)
                feat = self.block(f, hidden, hm5)
            hidden = feat
            sr = self.conv_out(self.conv_up_act(self.conv_up(feat))) + \
                inter_res
            heatmap, hg_hidden = self.hour_glass(sr, hg_hidden)
            sr_outputs.append(sr.permute(0, 3, 1, 2))
            heatmap_outputs.append(heatmap.permute(0, 3, 1, 2))
        return sr_outputs, heatmap_outputs

    @torch.no_grad()
    def init_seeded(self, generator: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, nn.PReLU):
                mod.weight.fill_(self.prelu_init)
