"""FCVSR-TFDC (counterpart of ``fcvsr_tpu.models.fcvsr_tfdc``; the
reference's ``GShiftNet`` of CVSR_freq_S.py).

FCVSR's topology with TFDC (temporal-frequency difference compensation)
in MGAA's place, ``SpaFreqBlock`` in MFFR's, and the width-4 cross-scale
trunk without context blocks (``sidecvsr._SCNetWide``, 3 groups) for
SCNet.  As in the JAX package, one ``TFDC`` module runs three times (the
first three frames, the last three, then the two results around the
centre frame) and one ``PReLU`` serves the whole tail.  No kernel of the
port lies on its path: cuDNN convs, cuFFT, and the port's resizes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.resize import resize_bilinear
from .blocks import Conv2d, PReLU, pixel_shuffle
from .blocks_ext import SpaFreqBlock, TFDC
from .sidecvsr import _SCNetWide

__all__ = ["FCVSRTFDCNet"]


class FCVSRTFDCNet(nn.Module):
    """(B, 7, C, H, W) -> (B, C, 4H, 4W); ``in_channels`` C (1: Y)."""

    def __init__(self, n_feats: int = 64, sc_groups: int = 3,
                 in_channels: int = 1):
        super().__init__()
        nf, c, t = n_feats, in_channels, 7
        self.n_feats = nf
        self.lrelu = PReLU()
        self.TFDC = TFDC(nf)
        self.feat_extract = Conv2d(t * c, t * nf, 3)
        self.Spa_freqblock0 = SpaFreqBlock(nf)
        self.rconcat1 = Conv2d(nf, nf, 3, stride=2)
        self.rconcat2 = Conv2d(nf, nf, 3, stride=2)
        self.recorb1 = _SCNetWide(nf, sc_groups)
        self.upconv1_L3 = Conv2d(nf, nf, 1)
        self.upconv1_L2 = Conv2d(nf, nf, 1)
        self.upconv1_L2_2 = Conv2d(nf + nf // 4, nf, 1)
        self.upconv_fuse = Conv2d(nf + nf // 4 + nf // 16, nf, 3)
        self.recorb0 = Conv2d(nf, nf, 3)
        self.upconv1 = Conv2d(nf, nf * 4, 3)
        self.upconv2 = Conv2d(nf, nf * 4, 3)
        self.conv_last0 = Conv2d(nf, c, 3)

    def forward(self, x):
        b, t, c, h, w = x.shape
        nf = self.n_feats
        center = x[:, t // 2].permute(0, 2, 3, 1)
        feats = x.permute(0, 3, 4, 1, 2).reshape(b, h, w, t * c)

        feat = self.feat_extract(feats)
        g1 = self.TFDC(feat[..., :3 * nf])
        g3 = self.TFDC(feat[..., 4 * nf:])
        g2 = self.TFDC(torch.cat([g1, feat[..., 3 * nf:4 * nf], g3], -1))

        dec = self.Spa_freqblock0(g2)
        dec1 = self.rconcat1(dec)
        dec2 = self.rconcat2(dec1)
        l1, l2, l3 = self.recorb1([dec, dec1, dec2])

        out_l3_1 = pixel_shuffle(self.lrelu(self.upconv1_L3(l3)))
        out_l3_2 = pixel_shuffle(out_l3_1)
        out_l2 = self.lrelu(self.upconv1_L2(l2))
        out_l2 = pixel_shuffle(out_l2 + self.upconv1_L2_2(
            torch.cat([out_l2, out_l3_1], -1)))
        fuse = self.recorb0(self.upconv_fuse(
            torch.cat([l1, out_l2, out_l3_2], -1)))
        out = self.lrelu(pixel_shuffle(self.upconv1(fuse)))
        out = self.lrelu(pixel_shuffle(self.upconv2(out)))
        out = self.conv_last0(out) + resize_bilinear(center, 4 * h, 4 * w)
        return out.permute(0, 3, 1, 2)
