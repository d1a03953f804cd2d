"""SIDECVSR, coding-prior guided compressed VSR (counterpart of
``fcvsr_tpu.models.sidecvsr``).

HEVC side information (motion vectors, residue, partition map, unfiltered
prediction) conditions the feature extractor through SFT layers; an
MV-guided local patch attention aligns the neighbours' features at three
pyramid scales; a cross-scale trunk of width-4 blocks without context
blocks (``_SCNetWide``, which FCVSR-TFDC runs too) reconstructs.

Quirks kept as the JAX package keeps them: the STN scales the motion as
``(mv / size * 2) * 32`` on a normalised grid clamped to [-1, 1], border
padding, corners aligned; the 3 x 3 patches are in torch-unfold order (c
major, tap minor) with zero padding; the attention is a *mean* over the 9
taps; ``mv_patch_attn``, ``attn_q``, ``attn_p`` and ``tsa_fusion`` are one
module each, shared by the 3 levels and the 6 neighbours.  Module names
are the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import (downsample2x_bilinear, resize_bilinear,
                          upsample2x_bilinear)
from ..ops.warp import grid_sample_bilinear
from .blocks import Conv2d, pixel_shuffle

__all__ = ["SIDECVSR", "MVLocalAttn", "SFTLayer", "ResBlockSFT"]


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _stn_warp(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """The reference STN: x (B, H, W, C) sampled at the normalised grid plus
    ``(mv / size * 2) * 32``, clamped to [-1, 1], border padding, corners
    aligned; u, v (B, H, W)."""
    b, h, w, c = x.shape
    gx = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
    gy = torch.linspace(-1.0, 1.0, h, dtype=x.dtype, device=x.device)
    my, mx = torch.meshgrid(gy, gx, indexing="ij")
    nx = (mx[None] + (u / w * 2) * 32).clamp(-1, 1)
    ny = (my[None] + (v / h * 2) * 32).clamp(-1, 1)
    px = ((nx + 1) / 2 * (w - 1)).reshape(b, h * w)
    py = ((ny + 1) / 2 * (h - 1)).reshape(b, h * w)
    return grid_sample_bilinear(x, px, py, "border").reshape(b, h, w, c)


def _unfold3(x: torch.Tensor) -> torch.Tensor:
    """3 x 3 patches, zero-padded: (B, H, W, C) -> (B, H, W, C * 9) in
    torch unfold's channel order (c, ky, kx)."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return torch.stack(taps, -1).reshape(b, h, w, c * 9)


class MVLocalAttn(nn.Module):
    """MV-guided local patch attention: the neighbour's 3 x 3 patches warped
    by its motion vectors, weighted by a softmax over the taps that two 1 x
    1 convs predict from them and the centre's patches, averaged."""

    def __init__(self, nf: int = 64):
        super().__init__()
        self.kp0 = Conv2d(2 * 9 * nf, 2 * nf, 1)
        self.kp1 = Conv2d(2 * nf, 9, 1)

    def forward(self, nbh_fea, cen_fea, mv):
        b, h, w, c = cen_fea.shape
        aligned = _stn_warp(_unfold3(nbh_fea), mv[..., 0], mv[..., 1])
        fuse = torch.cat([aligned, _unfold3(cen_fea)], -1)
        attn = torch.softmax(self.kp1(_lrelu(self.kp0(fuse))), -1)
        al = aligned.reshape(b, h, w, c, 9)
        return (al * attn[:, :, :, None, :]).mean(-1)


class SFTLayer(nn.Module):
    """Spatial feature transform: ``feas * (scale + 1) + shift``, both from
    1 x 1 convs over the features and the side information."""

    def __init__(self, nf: int = 64, side: int = 32):
        super().__init__()
        self.scale0 = Conv2d(nf + side, nf, 1)
        self.scale1 = Conv2d(nf, nf, 1)
        self.shift0 = Conv2d(nf + side, nf, 1)
        self.shift1 = Conv2d(nf, nf, 1)

    def forward(self, feas, side):
        x_in = torch.cat([feas, side], -1)
        scale = self.scale1(_lrelu(self.scale0(x_in)))
        shift = self.shift1(_lrelu(self.shift0(x_in)))
        return feas * (scale + 1) + shift


class ResBlockSFT(nn.Module):
    def __init__(self, nf: int = 64):
        super().__init__()
        self.sft0 = SFTLayer(nf, nf // 2)
        self.conv0 = Conv2d(nf, nf, 3)
        self.sft1 = SFTLayer(nf, nf // 2)
        self.conv1 = Conv2d(nf, nf, 3)

    def forward(self, feas, side):
        fea = torch.relu(self.conv0(self.sft0(feas, side)))
        return feas + self.conv1(self.sft1(fea, side))


class _WideBlock(nn.Module):
    """Width-4 cross-scale block over an [L1, L2, L3] pyramid, no context
    block; its convs start at kaiming-normal x 0.1 (``init_weights``)."""

    def __init__(self, nf: int, width_multiplier: int = 4):
        super().__init__()
        self.body0 = Conv2d(nf, nf * width_multiplier, 3)
        self.body1 = Conv2d(nf * width_multiplier, nf, 3)
        self.down = Conv2d(nf, nf, 1)
        self.up = Conv2d(nf, nf, 1)

    def forward(self, xs):
        res = [self.body1(_lrelu(self.body0(x))) for x in xs]
        down = [res[0]] + [downsample2x_bilinear(self.down(r))
                           for r in res[:-1]]
        up = [upsample2x_bilinear(self.up(r)) for r in res[1:]] + [res[-1]]
        return [x + r + d + u for x, r, d, u in zip(xs, res, down, up)]


class _SCNetWide(nn.Module):
    """``groups`` groups of 3 ``_WideBlock``s and a conv shared across the
    scales, each with a residual, and an outer residual."""

    def __init__(self, nf: int, groups: int = 4):
        super().__init__()
        self.groups = groups
        for g in range(groups):
            for i in range(3):
                self.add_module(f"g{g}_block{i}", _WideBlock(nf))
            self.add_module(f"g{g}_conv", Conv2d(nf, nf, 3))

    def forward(self, xs):
        res = list(xs)
        for g in range(self.groups):
            inner = res
            for i in range(3):
                inner = getattr(self, f"g{g}_block{i}")(inner)
            conv = getattr(self, f"g{g}_conv")
            res = [x + conv(r) for x, r in zip(res, inner)]
        return [x + r for x, r in zip(xs, res)]


class SIDECVSR(nn.Module):
    """x: (B, 7, 1, H, W) Y frames; mvs: (B, 7, 2, H, W) motion vectors in
    pixels; pms, rms, ufs: (B, 7, 1, H, W) partition map, residue and
    unfiltered prediction.  H and W multiples of 4.  Returns (sr (B, 1, 4H,
    4W), the L1 features (B * 7, H, W, nf), channels-last as the JAX
    package returns them: the reference's incremental window cache reads
    them).  The 6 neighbours of a level go through the shared attention as
    one batch."""

    def __init__(self, nf: int = 64, nframes: int = 7, sc_groups: int = 4):
        super().__init__()
        self.nf, self.nframes = nf, nframes
        self.conv_first = Conv2d(1, nf, 3)
        for i in range(4):
            self.add_module(f"side{i}", Conv2d(3 if i == 0 else nf // 2,
                                               nf // 2, 3))
        for i in range(7):
            self.add_module(f"sft_rb{i}", ResBlockSFT(nf))
        self.mv_patch_attn = MVLocalAttn(nf)
        self.attn_q = Conv2d(nf, nf, 3)
        self.attn_p = Conv2d(nf, nf, 3)
        self.tsa_fusion = Conv2d(nframes * nf, nf, 1)
        self.recon_trunk = _SCNetWide(nf, sc_groups)
        self.upconv1_L3 = Conv2d(nf, nf, 1)
        self.upconv1_L2 = Conv2d(nf, nf, 1)
        self.upconv1 = Conv2d(nf + nf // 4 + nf // 16, nf * 4, 3)
        self.upconv2 = Conv2d(nf, nf * 4, 1)
        self.conv_last = Conv2d(nf, 1, 3)

    def _fuse_level(self, fea, mv):
        """One pyramid level: fea (B, N, h, w, nf), mv (B, N, h, w, 2) ->
        the fused (B, h, w, nf)."""
        b, n, hh, ww, nf = fea.shape
        center = self.nframes // 2
        nbh = [i for i in range(n) if i != center]
        cen = fea[:, center]
        aligned = self.mv_patch_attn(
            fea[:, nbh].reshape(b * len(nbh), hh, ww, nf),
            cen[:, None].expand(b, len(nbh), hh, ww, nf).reshape(
                b * len(nbh), hh, ww, nf),
            mv[:, nbh].reshape(b * len(nbh), hh, ww, 2)).reshape(
                b, len(nbh), hh, ww, nf)
        stack = torch.cat([aligned[:, :center], cen[:, None],
                           aligned[:, center:]], 1)
        # fea_fusion: correlation-sigmoid temporal attention
        emb = self.attn_q(stack.reshape(b * n, hh, ww, nf)).reshape(
            b, n, hh, ww, nf)
        emb_ref = self.attn_p(emb[:, center])
        cor = torch.sigmoid((emb * emb_ref[:, None]).sum(-1))
        weighted = stack * cor[..., None]
        flat = weighted.permute(0, 2, 3, 1, 4).reshape(b, hh, ww, n * nf)
        return _lrelu(self.tsa_fusion(flat))

    def forward(self, x, mvs, pms, rms, ufs):
        b, n, c, h, w = x.shape
        if h % 4 or w % 4:
            raise ValueError(f"SIDECVSR takes H and W multiples of 4, not "
                             f"{h} x {w}")
        nf = self.nf
        center = self.nframes // 2
        xs = x.permute(0, 1, 3, 4, 2).reshape(b * n, h, w, c)
        x_center = x[:, center].permute(0, 2, 3, 1)

        l1 = _lrelu(self.conv_first(xs))
        side = torch.cat([v.permute(0, 1, 3, 4, 2).reshape(b * n, h, w, 1)
                          for v in (rms, pms, ufs)], -1)
        for i in range(4):
            side = _lrelu(getattr(self, f"side{i}")(side))
        for i in range(7):
            l1 = getattr(self, f"sft_rb{i}")(l1, side)

        l2 = downsample2x_bilinear(l1)
        l3 = downsample2x_bilinear(l2)
        mvs_hw = mvs.permute(0, 1, 3, 4, 2)    # (B, N, H, W, 2)
        fused = []
        for lv, fea in enumerate((l1, l2, l3)):
            hh, ww = h >> lv, w >> lv
            mv = mvs_hw if lv == 0 else (resize_bilinear(
                mvs_hw.reshape(b * n, h, w, 2), hh, ww) / 2.0 ** lv).reshape(
                    b, n, hh, ww, 2)
            fused.append(self._fuse_level(fea.reshape(b, n, hh, ww, nf), mv))

        o1, o2, o3 = self.recon_trunk(fused)
        out_l3 = pixel_shuffle(pixel_shuffle(_lrelu(self.upconv1_L3(o3))))
        out_l2 = pixel_shuffle(_lrelu(self.upconv1_L2(o2)))
        out = torch.cat([o1, out_l2, out_l3], -1)
        out = _lrelu(pixel_shuffle(self.upconv1(out)))
        out = _lrelu(pixel_shuffle(self.upconv2(out)))
        out = self.conv_last(out) + resize_bilinear(x_center, 4 * h, 4 * w)
        return out.permute(0, 3, 1, 2), l1
