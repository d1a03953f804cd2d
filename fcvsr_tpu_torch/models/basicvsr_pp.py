"""BasicVSR++ (counterpart of ``fcvsr_tpu.models.basicvsr_pp``), with
mmedit's ``BasicVSRPlusPlus`` parameter names.

SPyNet flows, four second-order propagation branches (backward_1,
forward_1, backward_2, forward_2) with flow-guided deformable alignment (16
deform groups, offset residues within +-max_residue_magnitude around the
flows), and a 5-block reconstruction over the concatenated branch features.
Time runs as a Python loop; as in mmedit, the first step of a branch has
nothing to align and skips the alignment (the JAX scan computes it and
zeroes it, with the same result), so a forward launches the DCN kernel
4 * (T - 1) times.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from ..ops.warp import flow_warp
from .basicvsr import (MMPixelShufflePack, MMResidualBlocksWithInputConv,
                       ModulatedDeformConv2d)
from .blocks import Conv2d
from .spynet import SpyNet

__all__ = ["BasicVSRPlusPlus", "SecondOrderDeformableAlignment"]

BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")


class SecondOrderDeformableAlignment(ModulatedDeformConv2d):
    """Flow-guided DCN over x = cat([feat_n1, feat_n2]) (2C channels): the
    offsets are residues predicted from cat([cond, flow_1, flow_2]), added
    to the flows, flow_1 for the first half of the deform groups (over
    feat_n1) and flow_2 for the second."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int = 16, max_residue_magnitude: float = 10.0):
        super().__init__(in_channels, out_channels, deform_groups)
        c = out_channels
        self.max_residue_magnitude = max_residue_magnitude
        self.conv_offset = nn.Sequential(
            Conv2d(3 * c + 4, c, 3), nn.LeakyReLU(0.1),
            Conv2d(c, c, 3), nn.LeakyReLU(0.1),
            Conv2d(c, c, 3), nn.LeakyReLU(0.1),
            Conv2d(c, 27 * deform_groups, 3))

    def forward(self, x, extra_feat, flow_1, flow_2):
        out = self.conv_offset(torch.cat([extra_feat, flow_1, flow_2], -1))
        o1, o2, mask = torch.chunk(out, 3, dim=-1)
        offset = self.max_residue_magnitude * torch.tanh(
            torch.cat([o1, o2], -1))
        off1, off2 = torch.chunk(offset, 2, dim=-1)
        # flows are (dx, dy), DCN offsets (dy, dx): flip, then one copy a tap
        n = off1.shape[-1] // 2
        offset = torch.cat([off1 + flow_1.flip(-1).repeat(1, 1, 1, n),
                            off2 + flow_2.flip(-1).repeat(1, 1, 1, n)], -1)
        return super().forward(x, offset, torch.sigmoid(mask))


class BasicVSRPlusPlus(nn.Module):
    """(B, T, 3, H, W) in [0, 1] -> (B, T, 3, 4H, 4W); H and W multiples of
    32 (SPyNet runs at the input's size).  The defaults are mmedit's
    basicvsr_plusplus_c64n7_8x1_600k_reds4."""

    def __init__(self, mid_channels: int = 64, num_blocks: int = 7,
                 max_residue_magnitude: float = 10.0):
        super().__init__()
        mid = mid_channels
        self.mid_channels = mid
        self.spynet = SpyNet()
        self.feat_extract = MMResidualBlocksWithInputConv(3, mid, 5)
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, name in enumerate(BRANCHES):
            self.deform_align[name] = SecondOrderDeformableAlignment(
                2 * mid, mid, 16, max_residue_magnitude)
            self.backbone[name] = MMResidualBlocksWithInputConv(
                (2 + i) * mid, mid, num_blocks)
        self.reconstruction = MMResidualBlocksWithInputConv(5 * mid, mid, 5)
        self.upsample1 = MMPixelShufflePack(mid, mid, 2, 3)
        self.upsample2 = MMPixelShufflePack(mid, 64, 2, 3)
        self.conv_hr = Conv2d(64, 64, 3)
        self.conv_last = Conv2d(64, 3, 3)

    def _propagate(self, name, spatial, priors, flows):
        """One branch over the T frames.  spatial: T maps (B, H, W, C);
        priors: the earlier branches' T maps each; flows (B, T-1, H, W, 2),
        flows[:, i] between frames i and i + 1.  Returns T maps."""
        t = len(spatial)
        backward = name.startswith("backward")
        order = range(t - 1, -1, -1) if backward else range(t)
        outs = [None] * t
        feat_n1 = feat_n2 = flow_prev = None
        for i, idx in enumerate(order):
            feat_current = spatial[idx]
            if i == 0:
                feat_prop = torch.zeros_like(feat_current)
            else:
                flow_n1 = flows[:, idx if backward else idx - 1]
                cond_n1 = flow_warp(feat_n1, flow_n1)
                if i > 1:
                    flow_n2 = flow_n1 + flow_warp(flow_prev, flow_n1)
                    cond_n2 = flow_warp(feat_n2, flow_n2)
                    f2 = feat_n2
                else:  # no second-order terms on the second step
                    flow_n2 = torch.zeros_like(flow_n1)
                    cond_n2 = f2 = torch.zeros_like(feat_n1)
                feat_prop = self.deform_align[name](
                    torch.cat([feat_n1, f2], -1),
                    torch.cat([cond_n1, feat_current, cond_n2], -1),
                    flow_n1, flow_n2)
                flow_prev = flow_n1
            feat_in = torch.cat([feat_current] + [p[idx] for p in priors]
                                + [feat_prop], -1)
            feat_prop = feat_prop + self.backbone[name](feat_in)
            outs[idx] = feat_prop
            feat_n1, feat_n2 = feat_prop, feat_n1
        return outs

    def forward(self, lqs):
        b, t, c, h, w = lqs.shape
        mid = self.mid_channels
        x = lqs.permute(0, 1, 3, 4, 2)                      # (B, T, H, W, C)
        feats = self.feat_extract(x.reshape(b * t, h, w, c)) \
            .reshape(b, t, h, w, mid)
        spatial = list(feats.unbind(1))
        ref = x[:, :-1].reshape(b * (t - 1), h, w, c)
        supp = x[:, 1:].reshape(b * (t - 1), h, w, c)
        flows_backward = self.spynet(ref, supp).reshape(b, t - 1, h, w, 2)
        flows_forward = self.spynet(supp, ref).reshape(b, t - 1, h, w, 2)

        branches = []
        for name in BRANCHES:
            flows = flows_backward if name.startswith("backward") \
                else flows_forward
            branches.append(self._propagate(name, spatial, branches, flows))

        hr = torch.cat([feats] + [torch.stack(f, 1) for f in branches], -1)
        hr = self.reconstruction(hr.reshape(b * t, h, w, 5 * mid))
        hr = F.leaky_relu(self.upsample1(hr), 0.1)
        hr = F.leaky_relu(self.upsample2(hr), 0.1)
        hr = self.conv_last(F.leaky_relu(self.conv_hr(hr), 0.1))
        hr = hr + resize_bilinear(x.reshape(b * t, h, w, c), 4 * h, 4 * w)
        return hr.reshape(b, t, 4 * h, 4 * w, c).permute(0, 1, 4, 2, 3)
