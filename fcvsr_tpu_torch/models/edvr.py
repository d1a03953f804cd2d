"""EDVR (counterpart of ``fcvsr_tpu.models.edvr``): pyramid cascading
deformable alignment and temporal-spatial attention fusion, with mmedit's
``EDVRNet`` parameter names.

The JAX package vmaps the alignment over the T frames of a window; here T is
folded into the batch against the reference pyramid repeated T times, so
each of the four DCNs (levels 3, 2, 1 and the cascade) is one kernel launch
a forward.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear, upsample2x_bilinear
from .basicvsr import (ConvModule, MMPixelShufflePack, MMResidualBlock,
                       ModulatedDeformConv2d)
from .blocks import Conv2d

__all__ = ["EDVRNet", "PCDAlignment", "TSAFusion", "ModulatedDCNPack"]


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


class ModulatedDCNPack(ModulatedDeformConv2d):
    """DCNv2 whose offsets and mask come from a separate feature: a 3-way
    split of ``conv_offset`` into o1, o2 and the mask logits, the offset
    read as cat([o1, o2]) in (deform group, tap, [dy, dx]) order."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int = 8):
        super().__init__(in_channels, out_channels, deform_groups)
        self.conv_offset = Conv2d(in_channels, deform_groups * 27, 3)

    def forward(self, x, extra_feat):
        o1, o2, mask = torch.chunk(self.conv_offset(extra_feat), 3, dim=-1)
        return super().forward(x, torch.cat([o1, o2], -1), torch.sigmoid(mask))


class PCDAlignment(nn.Module):
    """Pyramid cascading deformable alignment: neighbour and reference
    pyramids [L1, L2, L3], each (N, h, w, C) -> aligned L1 (N, H, W, C)."""

    def __init__(self, mid_channels: int = 64, deform_groups: int = 8):
        super().__init__()
        c = mid_channels
        self.offset_conv1 = nn.ModuleDict()
        self.offset_conv2 = nn.ModuleDict()
        self.offset_conv3 = nn.ModuleDict()
        self.dcn_pack = nn.ModuleDict()
        self.feat_conv = nn.ModuleDict()
        for i in (3, 2, 1):
            lv = f"l{i}"
            self.offset_conv1[lv] = ConvModule(2 * c, c)
            if i == 3:
                self.offset_conv2[lv] = ConvModule(c, c)
            else:
                self.offset_conv2[lv] = ConvModule(2 * c, c)
                self.offset_conv3[lv] = ConvModule(c, c)
            self.dcn_pack[lv] = ModulatedDCNPack(c, c, deform_groups)
            if i < 3:
                self.feat_conv[lv] = ConvModule(2 * c, c, act=i == 2)
        self.cas_offset_conv1 = ConvModule(2 * c, c)
        self.cas_offset_conv2 = ConvModule(c, c)
        self.cas_dcnpack = ModulatedDCNPack(c, c, deform_groups)

    def forward(self, nbr, ref):
        up_off = up_feat = feat = None
        for i in (3, 2, 1):
            lv = f"l{i}"
            off = self.offset_conv1[lv](torch.cat([nbr[i - 1], ref[i - 1]], -1))
            if i == 3:
                off = self.offset_conv2[lv](off)
            else:
                off = self.offset_conv2[lv](torch.cat([off, up_off], -1))
                off = self.offset_conv3[lv](off)
            feat = self.dcn_pack[lv](nbr[i - 1], off)
            if i == 3:
                feat = _lrelu(feat)
            else:
                feat = self.feat_conv[lv](torch.cat([feat, up_feat], -1))
            if i > 1:
                up_off = upsample2x_bilinear(off) * 2.0
                up_feat = upsample2x_bilinear(feat)
        off = self.cas_offset_conv2(self.cas_offset_conv1(
            torch.cat([feat, ref[0]], -1)))
        return _lrelu(self.cas_dcnpack(feat, off))


def _nchw(fn, x):
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _max_pool_3s2(x):
    return _nchw(lambda v: F.max_pool2d(v, 3, 2, 1), x)


def _avg_pool_3s2(x):
    """AvgPool2d(3, 2, 1), counting the zero padding (torch's default)."""
    return _nchw(lambda v: F.avg_pool2d(v, 3, 2, 1, count_include_pad=True), x)


class TSAFusion(nn.Module):
    """Temporal-spatial attention fusion: aligned (B, T, H, W, C) ->
    (B, H, W, C)."""

    def __init__(self, mid_channels: int = 64, num_frames: int = 5,
                 center_frame_idx: int = 2):
        super().__init__()
        c = mid_channels
        self.center_frame_idx = center_frame_idx
        self.temporal_attn1 = Conv2d(c, c, 3)
        self.temporal_attn2 = Conv2d(c, c, 3)
        self.feat_fusion = ConvModule(num_frames * c, c, 1)
        self.spatial_attn1 = ConvModule(num_frames * c, c, 1)
        self.spatial_attn2 = ConvModule(2 * c, c, 1)
        self.spatial_attn3 = ConvModule(c, c, 3)
        self.spatial_attn4 = ConvModule(c, c, 1)
        self.spatial_attn5 = Conv2d(c, c, 3)
        self.spatial_attn_l1 = ConvModule(c, c, 1)
        self.spatial_attn_l2 = ConvModule(2 * c, c, 3)
        self.spatial_attn_l3 = ConvModule(c, c, 3)
        self.spatial_attn_add1 = ConvModule(c, c, 1)
        self.spatial_attn_add2 = Conv2d(c, c, 1)

    def forward(self, aligned):
        b, t, h, w, c = aligned.shape
        emb_ref = self.temporal_attn1(aligned[:, self.center_frame_idx])
        emb = self.temporal_attn2(aligned.reshape(b * t, h, w, c))
        corr = (emb.reshape(b, t, h, w, c) * emb_ref[:, None]).sum(-1)
        prob = torch.sigmoid(corr)[..., None]
        weighted = (aligned * prob).permute(0, 2, 3, 1, 4).reshape(b, h, w,
                                                                   t * c)
        feat = self.feat_fusion(weighted)
        attn = self.spatial_attn1(weighted)
        attn = self.spatial_attn2(torch.cat(
            [_max_pool_3s2(attn), _avg_pool_3s2(attn)], -1))
        attn_level = self.spatial_attn_l1(attn)
        attn_level = self.spatial_attn_l2(torch.cat(
            [_max_pool_3s2(attn_level), _avg_pool_3s2(attn_level)], -1))
        attn_level = upsample2x_bilinear(self.spatial_attn_l3(attn_level))
        attn = self.spatial_attn3(attn) + attn_level
        attn = upsample2x_bilinear(self.spatial_attn4(attn))
        attn = self.spatial_attn5(attn)
        attn_add = self.spatial_attn_add2(self.spatial_attn_add1(attn))
        return feat * torch.sigmoid(attn) * 2 + attn_add


class EDVRNet(nn.Module):
    """(B, T, C, H, W) in [0, 1] -> the x4 centre frame (B, C, 4H, 4W); H and
    W multiples of 4.  The defaults are mmedit's EDVR-M
    (edvrm_x4_g8_600k_reds); the fusion is always TSA, as there."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, num_frames: int = 5,
                 deform_groups: int = 8, num_blocks_extraction: int = 5,
                 num_blocks_reconstruction: int = 10,
                 center_frame_idx: int = 2):
        super().__init__()
        mid = mid_channels
        self.mid_channels, self.center_frame_idx = mid, center_frame_idx
        self.conv_first = Conv2d(in_channels, mid, 3)
        self.feature_extraction = nn.Sequential(
            *[MMResidualBlock(mid) for _ in range(num_blocks_extraction)])
        self.feat_l2_conv1 = ConvModule(mid, mid, 3, stride=2)
        self.feat_l2_conv2 = ConvModule(mid, mid, 3)
        self.feat_l3_conv1 = ConvModule(mid, mid, 3, stride=2)
        self.feat_l3_conv2 = ConvModule(mid, mid, 3)
        self.pcd_alignment = PCDAlignment(mid, deform_groups)
        self.fusion = TSAFusion(mid, num_frames, center_frame_idx)
        self.reconstruction = nn.Sequential(
            *[MMResidualBlock(mid) for _ in range(num_blocks_reconstruction)])
        self.upsample1 = MMPixelShufflePack(mid, mid, 2, 3)
        self.upsample2 = MMPixelShufflePack(mid, 64, 2, 3)
        self.conv_hr = Conv2d(64, 64, 3)
        self.conv_last = Conv2d(64, out_channels, 3)

    def forward(self, x):
        b, t, c, h, w = x.shape
        mid, ci = self.mid_channels, self.center_frame_idx
        xs = x.permute(0, 1, 3, 4, 2).reshape(b * t, h, w, c)
        l1 = self.feature_extraction(_lrelu(self.conv_first(xs)))
        l2 = self.feat_l2_conv2(self.feat_l2_conv1(l1))
        l3 = self.feat_l3_conv2(self.feat_l3_conv1(l2))
        nbr = [l1, l2, l3]
        # each window's centre level, repeated for its T frames
        refs = [f.reshape((b, t) + f.shape[1:])[:, ci:ci + 1]
                .expand((b, t) + f.shape[1:]).reshape(f.shape) for f in nbr]
        aligned = self.pcd_alignment(nbr, refs).reshape(b, t, h, w, mid)
        out = self.reconstruction(self.fusion(aligned))
        out = _lrelu(self.upsample1(out))
        out = _lrelu(self.upsample2(out))
        out = self.conv_last(_lrelu(self.conv_hr(out)))
        center = x[:, ci].permute(0, 2, 3, 1)
        out = out + resize_bilinear(center, 4 * h, 4 * w)
        return out.permute(0, 3, 1, 2)
