"""IconVSR and TDAN (counterpart of ``fcvsr_tpu.models.iconvsr``), with
mmedit's parameter names.

* ``IconVSR`` - BasicVSR's two propagations with an information refill at
  keyframes (every ``keyframe_stride`` frames, and the last): the EDVR
  features of each keyframe's window (``edvr.EDVRFeatureExtractor``,
  EDVR's trunk to its TSA fusion, whose PCD alignment launches the DCN
  kernel 4 times a window), cut from the clip mirror-padded by
  ``padding`` frames, are fused into the carried feature.  Inputs are
  reflect-padded to multiples of 4.  The refill extractor is the submodule
  ``edvr`` and SPyNet ``spynet``, the names ``restorers.FROZEN_NAMES``
  freezes before ``fix_iter``.
* ``DeformConvPack`` / ``AugmentedDeformConvPack`` - mmcv's DCNv1 packs
  (no mask, no bias, 8 deform groups; offsets from a zero-initialised 3x3
  conv of the input itself, or of another feature), on the DCN kernel of
  ``ops.fused_dcn``.
* ``TDANNet`` - each neighbour's features aligned to the centre frame's by
  four DCNv1s, turned back into an LR frame, and the 5 aligned frames
  reconstructed at x4.  It returns (SR centre frame, aligned LR frames) as
  the JAX model does, so ``apis.restoration_video_inference`` and
  ``VideoRestorer`` do not take it: it serves through its forward and
  trains on a loss of its SR output.  The 4 neighbours share the
  alignment's weights and run as one batch (the JAX package loops over
  them): 4 DCN launches a forward.

Modules take channels-first clips (B, T, C, H, W) and work channels-last
inside.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from ..ops.warp import flow_warp
from .basicvsr import (ConvModule, MMPixelShufflePack, MMResidualBlock,
                       MMResidualBlocksWithInputConv, ModulatedDeformConv2d)
from .blocks import Conv2d
from .edvr import EDVRFeatureExtractor
from .spynet import SpyNet

__all__ = ["IconVSR", "DeformConvPack", "AugmentedDeformConvPack",
           "TDANNet"]


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


class IconVSR(nn.Module):
    """(B, T, 3, H, W) in [0, 1] -> (B, T, 3, 4H, 4W); T >= 5 (the refill's
    mirror padding reads frames 1-4 from each end), H and W at least 64
    and, padded to multiples of 4, multiples of 32 for SPyNet.  The
    defaults are mmedit's iconvsr_reds4."""

    def __init__(self, mid_channels: int = 64, num_blocks: int = 30,
                 keyframe_stride: int = 5, padding: int = 2):
        super().__init__()
        if padding not in (2, 3):
            raise ValueError(f"padding must be 2 or 3, not {padding}")
        mid = mid_channels
        self.mid_channels, self.keyframe_stride = mid, keyframe_stride
        self.padding = padding
        self.spynet = SpyNet()
        self.edvr = EDVRFeatureExtractor(mid, 2 * padding + 1,
                                         center_frame_idx=padding)
        self.backward_fusion = Conv2d(2 * mid, mid, 3)
        self.backward_resblocks = MMResidualBlocksWithInputConv(
            mid + 3, mid, num_blocks)
        self.forward_fusion = Conv2d(2 * mid, mid, 3)
        self.forward_resblocks = MMResidualBlocksWithInputConv(
            2 * mid + 3, mid, num_blocks)
        self.upsample1 = MMPixelShufflePack(mid, mid, 2, 3)
        self.upsample2 = MMPixelShufflePack(mid, 64, 2, 3)
        self.conv_hr = Conv2d(64, 64, 3)
        self.conv_last = Conv2d(64, 3, 3)

    def keyframes(self, t: int) -> list:
        """Every ``keyframe_stride``-th frame of t, and the last."""
        keys = list(range(0, t, self.keyframe_stride))
        if keys[-1] != t - 1:
            keys.append(t - 1)
        return keys

    def forward(self, lrs):
        b, t, c, h_in, w_in = lrs.shape
        mid = self.mid_channels
        ph, pw = (4 - h_in % 4) % 4, (4 - w_in % 4) % 4
        x = lrs
        if ph or pw:
            x = F.pad(x.reshape(b * t, c, h_in, w_in), (0, pw, 0, ph),
                      mode="reflect").reshape(b, t, c, h_in + ph, w_in + pw)
        x = x.permute(0, 1, 3, 4, 2)                        # (B, T, H, W, C)
        h, w = x.shape[2:4]
        ref = x[:, :-1].reshape(b * (t - 1), h, w, c)
        supp = x[:, 1:].reshape(b * (t - 1), h, w, c)
        flows_backward = self.spynet(ref, supp).reshape(b, t - 1, h, w, 2)
        flows_forward = self.spynet(supp, ref).reshape(b, t - 1, h, w, 2)

        # the refill's features at each keyframe, of the mirror-padded clip
        p = self.padding
        head, tail = ([4, 3], [-4, -5]) if p == 2 else \
            ([6, 5, 4], [-5, -6, -7])
        clip = torch.cat([x[:, head], x, x[:, tail]], 1)
        keys = self.keyframes(t)
        refill = {i: self.edvr(clip[:, i:i + 2 * p + 1]) for i in keys}

        feat_prop = x.new_zeros((b, h, w, mid))
        outs_b = [None] * t
        for i in range(t - 1, -1, -1):
            if i < t - 1:
                feat_prop = flow_warp(feat_prop, flows_backward[:, i])
            if i in refill:
                feat_prop = self.backward_fusion(
                    torch.cat([feat_prop, refill[i]], -1))
            feat_prop = self.backward_resblocks(
                torch.cat([x[:, i], feat_prop], -1))
            outs_b[i] = feat_prop
        feat_prop = torch.zeros_like(feat_prop)
        outs_f = []
        for i in range(t):
            if i > 0:
                feat_prop = flow_warp(feat_prop, flows_forward[:, i - 1])
            if i in refill:
                feat_prop = self.forward_fusion(
                    torch.cat([feat_prop, refill[i]], -1))
            feat_prop = self.forward_resblocks(
                torch.cat([x[:, i], outs_b[i], feat_prop], -1))
            outs_f.append(feat_prop)

        # the upsampling of every frame as one batch
        out = torch.stack(outs_f, 1).reshape(b * t, h, w, mid)
        out = _lrelu(self.upsample1(out))
        out = _lrelu(self.upsample2(out))
        out = self.conv_last(_lrelu(self.conv_hr(out)))
        out = out + resize_bilinear(x.reshape(b * t, h, w, c), 4 * h, 4 * w)
        out = out.reshape(b, t, 4 * h, 4 * w, c)[:, :, :4 * h_in, :4 * w_in]
        return out.permute(0, 1, 4, 2, 3)


class DeformConvPack(ModulatedDeformConv2d):
    """mmcv's DeformConv2dPack: 3x3 DCNv1 without a bias whose offsets, in
    (deform group, tap, [dy, dx]) order, a 3x3 conv predicts from the input
    itself."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int = 8):
        super().__init__(in_channels, out_channels, deform_groups, bias=False)
        self.conv_offset = Conv2d(in_channels, deform_groups * 18, 3)

    def forward(self, x):
        return super().forward(x, self.conv_offset(x), None)


class AugmentedDeformConvPack(DeformConvPack):
    """TDAN's AugmentedDeformConv2dPack: DCNv1 whose offsets come from
    another feature."""

    def forward(self, x, extra_feat):
        return ModulatedDeformConv2d.forward(
            self, x, self.conv_offset(extra_feat), None)


class TDANNet(nn.Module):
    """(B, T, 3, H, W) in [0, 1] -> (SR centre frame (B, 3, 4H, 4W), aligned
    LR frames (B, T, 3, H, W), the centre one the input's).  The defaults
    are mmedit's TDANNet's (64 channels, 5 blocks before the alignment, 10
    after)."""

    def __init__(self, mid_channels: int = 64,
                 num_blocks_before_align: int = 5,
                 num_blocks_after_align: int = 10, num_frames: int = 5):
        super().__init__()
        mid = mid_channels
        self.mid_channels = mid
        self.feat_extract = nn.Sequential(
            ConvModule(3, mid, 3),
            nn.Sequential(*[MMResidualBlock(mid)
                            for _ in range(num_blocks_before_align)]))
        self.feat_aggregate = nn.Sequential(
            Conv2d(2 * mid, mid, 3), DeformConvPack(mid, mid),
            DeformConvPack(mid, mid))
        self.align_1 = AugmentedDeformConvPack(mid, mid)
        self.align_2 = DeformConvPack(mid, mid)
        self.to_rgb = Conv2d(mid, 3, 3)
        self.reconstruct = nn.Sequential(
            ConvModule(3 * num_frames, mid, 3),
            nn.Sequential(*[MMResidualBlock(mid)
                            for _ in range(num_blocks_after_align)]),
            MMPixelShufflePack(mid, mid, 2, 3),
            MMPixelShufflePack(mid, mid, 2, 3),
            Conv2d(mid, 3, 3, bias=False))

    def forward(self, lrs):
        b, t, c, h, w = lrs.shape
        mid, ci = self.mid_channels, t // 2
        x = lrs.permute(0, 1, 3, 4, 2)                      # (B, T, H, W, C)
        feats = self.feat_extract(x.reshape(b * t, h, w, c)) \
            .reshape(b, t, h, w, mid)
        nbrs = [i for i in range(t) if i != ci]
        n = len(nbrs)
        # the neighbours as one batch, neighbour-major
        feat_nbr = feats[:, nbrs].transpose(0, 1).reshape(n * b, h, w, mid)
        feat_center = feats[:, ci].repeat(n, 1, 1, 1)
        agg = self.feat_aggregate(torch.cat([feat_center, feat_nbr], -1))
        rgb = self.to_rgb(self.align_2(self.align_1(feat_nbr, agg)))
        rgb = rgb.reshape(n, b, h, w, c)
        aligned = [x[:, i] if i == ci else rgb[nbrs.index(i)]
                   for i in range(t)]
        out = self.reconstruct(torch.cat(aligned, -1))
        return (out.permute(0, 3, 1, 2),
                torch.stack(aligned, 1).permute(0, 1, 4, 2, 3))
