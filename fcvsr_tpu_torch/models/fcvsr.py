"""FCVSR (counterpart of ``fcvsr_tpu.models.fcvsr``).

* ``MGAA``     - motion-guided adaptive alignment in the frequency domain.
* ``MFFR``     - multi-frequency feature refinement.
* ``FCVSRNet`` - 7 LR frames -> the x4 centre frame.

Reference behaviours kept (shipped checkpoints depend on them): SAC applies
kernel1 in both passes; the forward correlation feature conditions both
offset directions; the CorrBlock memory-reinterpret reshape; identity flow
features are zero; DivEnh's conv is dead weight.  Parameter names are the
reference checkpoint keys.  Features are channels-last inside the model.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import _native
from ..ops.corr import corr_lookup
from ..ops.freq import irfft_features, rfft_features, split_freq
from ..ops.fused_conv import conv3x3
from ..ops.resize import resize_bilinear
from ..ops.sac import iac
from .basicvsr import MMResidualBlock, ModulatedDeformConv2d
from .blocks import (BlockRCB, CALayer, Conv2d, ConvBlk, DivEnh, PReLU, RCB,
                     SCNet, pixel_shuffle)
from .scnet_rows import conv_bias, hwio

__all__ = ["MGAA", "MFFR", "FCVSRNet", "init_weights"]


class MGAA(nn.Module):
    """Motion-guided adaptive alignment: (B, H, W, 3*dim) -> (B, H, W, dim),
    the centre group aligned with its two neighbours.

    ``k_fused``: the IAC kernel computes the per-pixel kernels from F.0's
    output and F.1's selected weights, so F.1's output is never made.  It
    is inference only: a forward that autograd records raises."""

    def __init__(self, dim: int, ac_ks: int = 3, ac_num: int = 6,
                 corr_radius: int = 4, k_fused: bool = False):
        super().__init__()
        if ac_ks != 3:
            raise ValueError(f"the IAC kernel has 3 taps, not ac_ks={ac_ks}")
        d = dim
        self.dim, self.ac_ks, self.ac_num = d, ac_ks, ac_num
        self.corr_radius, self.k_fused = corr_radius, k_fused
        self.convfuse = nn.Sequential(
            Conv2d(4 * d, 2 * d, 1, bias=False), nn.ReLU(),
            Conv2d(2 * d, 2 * d, 1, bias=False), nn.ReLU(),
            Conv2d(2 * d, 2 * d, 1, bias=False))
        n_corr = (2 * corr_radius + 1) ** 2
        self.convcorr = nn.Sequential(
            Conv2d(2 * d + n_corr + 2, d, 1, bias=False), nn.ReLU(),
            Conv2d(d, d, 1, bias=False), nn.ReLU(),
            Conv2d(d, 4, 1, bias=False))
        self.MConvB = nn.ModuleList([ConvBlk(4, i) for i in range(ac_num)])
        self.convcrt = nn.Sequential(
            Conv2d(2 * d, d, 1, bias=False), nn.ReLU(),
            Conv2d(d, 4, 1, bias=False))
        self.conv_KP = Conv2d(d, d, 3)
        self.F = nn.Sequential(Conv2d(d, d, 3),
                               Conv2d(d, ac_num * d * ac_ks * 2, 1))
        self.conv3 = Conv2d(2 * d, d, 3, bias=False)
        # F.1 output channels of the kernel1 halves, tap-major per iteration:
        # the kernel2 halves are dead under the kernel1-both reference bug
        half = d * ac_ks
        self.register_buffer("sel", torch.tensor(
            [i * 2 * half + c * ac_ks + t for i in range(ac_num)
             for t in range(ac_ks) for c in range(d)]), persistent=False)

    def sel_weights(self):
        """F.1's weight, its (C0, n*3C) transpose for ``k_fused``, and its
        bias at the ``sel`` rows.  Under autograd they are selected from the
        live parameters on every call, so F.1 gets its gradient; otherwise
        they are made once, detached, and again only when F.1 changes."""
        w, b = self.F[1].weight, self.F[1].bias
        if _native.records(w, b):
            wsel = w.index_select(0, self.sel)
            return wsel, wsel[:, :, 0, 0].t().contiguous(), \
                b.index_select(0, self.sel)
        key = (w.data_ptr(), w._version, b.data_ptr(), b._version, w.device)
        cached = self.__dict__.get("_sel_weights")
        if cached is None or cached[0] != key:
            wsel = w.detach().index_select(0, self.sel)
            cached = (key, wsel, wsel[:, :, 0, 0].t().contiguous(),
                      b.detach().index_select(0, self.sel))
            self.__dict__["_sel_weights"] = cached
        return cached[1:]

    def forward(self, x):
        d = self.dim
        b, h, w, _ = x.shape
        x1, x2, x3 = x[..., :d], x[..., d:2 * d], x[..., 2 * d:]

        xf = rfft_features(x, groups=3)  # [imag_g, real_g] per group
        x1f, x2f, x3f = xf[..., :2 * d], xf[..., 2 * d:4 * d], xf[..., 4 * d:]
        off_f = (x1f - x2f) + self.convfuse(torch.cat([x1f, x2f], -1))
        off_b = (x3f - x2f) + self.convfuse(torch.cat([x3f, x2f], -1))
        sim = self.convcrt(x2f)

        corrf = corr_lookup(x1f, x2f, self.corr_radius)
        zero_flow = off_f.new_zeros(off_f.shape[:3] + (2,))
        off_f = self.convcorr(torch.cat([off_f, corrf, zero_flow], -1))
        off_b = self.convcorr(torch.cat([off_b, corrf, zero_flow], -1))

        # per-iteration offset fields: ConvBlk -> gate -> one batched irfft
        # over all 2*ac_num gated spectra, each [re(2), im(2)]
        gated = []
        for blk in self.MConvB:
            gated += [blk(off_f) * sim, blk(off_b) * sim]
        packed = torch.cat([g[..., :2] for g in gated]
                           + [g[..., 2:] for g in gated], -1)
        fields = irfft_features(packed, h, w)      # (B, H, W, 4 * ac_num)
        offsets_f = torch.stack([fields[..., 4 * i:4 * i + 2]
                                 for i in range(self.ac_num)])
        offsets_b = torch.stack([fields[..., 4 * i + 2:4 * i + 4]
                                 for i in range(self.ac_num)])

        f0 = self.F[0](self.conv_KP(x2))
        wsel, wsel_t, bsel = self.sel_weights()
        if self.k_fused and (f0.requires_grad or wsel.requires_grad):
            raise RuntimeError(
                "MGAA(k_fused=True) is inference only: the fused kernel "
                "prediction has no backward.  Train with k_fused=False, or "
                "run the forward under torch.no_grad()")
        if self.k_fused:
            k_parts = (f0.contiguous(), wsel_t, bsel)
            pred_k = None
        else:
            k_parts = None
            pred_k = F.conv2d(f0.permute(0, 3, 1, 2), wsel, bsel) \
                .permute(0, 2, 3, 1)
        aligned = [iac(feat, pred_k, offs, self.ac_num, d, k_parts=k_parts)
                   for feat, offs in ((x1, offsets_f), (x3, offsets_b))]
        return self.conv3(torch.cat(aligned, -1)) + x2


class MFFR(nn.Module):
    """Multi-frequency feature refinement."""

    def __init__(self, dim: int, freq_inv: int = 8):
        super().__init__()
        self.freq_inv = freq_inv
        self.DivEnh_block = nn.ModuleList([DivEnh(dim) for _ in range(freq_inv)])
        self.ca = CALayer(dim)

    def forward(self, x):
        freq = split_freq(x, self.freq_inv).flip(0)  # low-to-high band order
        enhanced_sum = raw_sum = out_sum = None
        for i, de in enumerate(self.DivEnh_block):
            fo = de(freq[i]) if i == 0 else de(freq[i], raw_sum, enhanced_sum)
            raw_sum = freq[i] if raw_sum is None else raw_sum + freq[i]
            enhanced_sum = fo if enhanced_sum is None else enhanced_sum + fo
            out_sum = fo if out_sum is None else out_sum + fo
        return self.ca(out_sum) + x


class FCVSRNet(nn.Module):
    """FCVSR: (B, 7, C, H, W) in [0, 1] -> (B, C, 4H, 4W).

    ``in_channels`` is 1 (Y) or 3 (RGB).  FCVSR-S is the same topology with
    ac_num=3, freq_inv=4, sc_groups=4 and 1x1 upsampling convs
    (:meth:`small`).  ``k_fused`` is MGAA's fused kernel prediction."""

    def __init__(self, n_feats: int = 64, in_channels: int = 1, ac_ks: int = 3,
                 ac_num: int = 6, freq_inv: int = 8, sc_groups: int = 10,
                 up_ksize: int = 3, num_frames: int = 7, k_fused: bool = False,
                 device=None):
        super().__init__()
        nf = n_feats
        self.nf, self.num_frames = nf, num_frames
        self.feat_extract = nn.Sequential(
            Conv2d(num_frames * in_channels, num_frames * nf, 3))
        self.lrelu = PReLU()
        self.MGAA = MGAA(nf, ac_ks, ac_num, k_fused=k_fused)
        self.rconcat1 = Conv2d(nf, nf, 3, stride=2)
        self.rconcat2 = Conv2d(nf, nf, 3, stride=2)
        self.recorb1 = SCNet(nf, sc_groups)
        self.recorb0 = Conv2d(nf, nf, 3)
        ks = up_ksize
        self.upconv1_L2 = Conv2d(nf, nf, ks)
        self.upconv1_L2_2 = Conv2d(nf + nf // 4, nf, ks)
        self.upconv1_L3 = Conv2d(nf, nf, ks)
        self.upconv1 = Conv2d(nf, nf * 4, ks)
        self.upconv2 = Conv2d(nf, nf * 4, ks)
        self.conv_last0 = Conv2d(nf, in_channels, 3)
        self.MFFRblock = MFFR(nf, freq_inv)
        self.upconv_fuse = Conv2d(nf + nf // 4 + nf // 16, nf, 3)
        if device is not None:
            self.to(device)

    @classmethod
    def small(cls, in_channels: int = 1, **kw):
        return cls(in_channels=in_channels, ac_num=3, freq_inv=4, sc_groups=4,
                   up_ksize=1, **kw)

    def forward(self, x):
        b, t, c, h, w = x.shape
        nf = self.nf
        center = x[:, t // 2].permute(0, 2, 3, 1)            # (B, H, W, C)
        feats = x.permute(0, 3, 4, 1, 2).reshape(b, h, w, t * c)

        feat = self.feat_extract(feats)
        f1, f2, f3 = feat[..., :3 * nf], feat[..., 3 * nf:4 * nf], \
            feat[..., 4 * nf:]
        g1 = self.MGAA(f1)
        g3 = self.MGAA(f3)
        g2 = self.MGAA(torch.cat([g1, f2, g3], -1))

        dec = self.MFFRblock(g2)
        dec1 = self.rconcat1(dec)
        dec2 = self.rconcat2(dec1)
        l1, l2, l3 = self.recorb1([dec, dec1, dec2])

        lrelu = self.lrelu
        out_l3 = lrelu(self.upconv1_L3(l3))
        out_l3_1 = pixel_shuffle(out_l3)
        out_l3_2 = pixel_shuffle(out_l3_1)
        out_l2 = lrelu(self.upconv1_L2(l2))
        out_l2 = pixel_shuffle(
            out_l2 + self.upconv1_L2_2(torch.cat([out_l2, out_l3_1], -1)))
        fuse = torch.cat([l1, out_l2, out_l3_2], -1)
        fuse = self.recorb0(self.upconv_fuse(fuse))
        up = lrelu(pixel_shuffle(self.upconv1(fuse)))
        up = lrelu(pixel_shuffle(self.upconv2(up)))
        last = self.conv_last0
        out = conv3x3(up.contiguous(), hwio(last), conv_bias(last))
        out = out + resize_bilinear(center, 4 * h, 4 * w)
        return out.permute(0, 3, 1, 2)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded re-initialisation of every parameter.

    Convs get torch's default U(+-1/sqrt(fan_in)) for weight and bias; the
    residual blocks the reference re-initialises (SCNet's BlockRCB and its
    RCB, mmedit's ResidualBlockNoBN) get kaiming-normal x 0.1 with zero
    bias, which keeps deep stacks stable; a deformable conv gets
    U(+-1/sqrt(fan_in)), a zero bias and a zero last offset conv (zero
    offsets, mask 0.5); PReLU slopes are 0.25 and DivEnh keeps a = 0,
    b = 1."""
    scaled, zeroed = set(), set()
    for mod in model.modules():
        if isinstance(mod, (BlockRCB, RCB, MMResidualBlock)):
            scaled.update(id(m) for m in mod.modules()
                          if isinstance(m, nn.Conv2d))
        elif isinstance(mod, ModulatedDeformConv2d):
            zeroed.add(id([m for m in mod.conv_offset.modules()
                           if isinstance(m, nn.Conv2d)][-1]))
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, ModulatedDeformConv2d)):
            wt = mod.weight
            fan_in = wt.shape[1] * wt.shape[2] * wt.shape[3]
            if id(mod) in zeroed:
                wt.zero_()
                mod.bias.zero_()
            elif isinstance(mod, ModulatedDeformConv2d):
                wt.copy_((torch.rand(wt.shape, generator=generator) * 2 - 1)
                         * fan_in ** -0.5)
                mod.bias.zero_()
            elif id(mod) in scaled:
                std = (2.0 / fan_in) ** 0.5 * 0.1
                wt.copy_(torch.randn(wt.shape, generator=generator) * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            else:
                bound = fan_in ** -0.5
                wt.copy_((torch.rand(wt.shape, generator=generator) * 2 - 1)
                         * bound)
                if mod.bias is not None:
                    mod.bias.copy_(
                        (torch.rand(mod.bias.shape, generator=generator) * 2
                         - 1) * bound)
        elif isinstance(mod, nn.PReLU):
            mod.weight.fill_(0.25)
        elif isinstance(mod, DivEnh):
            mod.a.zero_()
            mod.b.fill_(1.0)
    return model
