"""FTVSR and TTVSR (counterpart of ``fcvsr_tpu.models.ftvsr``): the
compressed-VSR baselines with trajectory-tracked attention and, in FTVSR,
a frequency transformer over 8x8 DCT coefficients.

``FTVSRNet`` runs SPyNet flows between neighbours, a feature extractor, and
a backward and a forward recurrent propagation: the carried feature is
warped by the flow, then :class:`LTAM` attends from the current frame to
the keyframes' cross-scale features at the locations each keyframe's
trajectory has reached (warped block by block, nearest pixel), and a
residual trunk takes the frame and the result.  Pixel-shuffle upsampling
over a bilinear x4 base follows.  FTVSR then pads the outputs and the base
to whole 8x8 blocks, runs SPyNet on the x4 outputs, takes both to DCT
coefficients, normalises them per channel over the blocks, and propagates
:class:`FTTALayer` attention over patch tokens of those coefficients in
both directions before adding the result back through the inverse DCT.
``TTVSRNet`` is FTVSR's recurrent core alone (60 blocks, no FTT).

Kept from the JAX package, and through it from the reference: LTAM's
``fusion`` conv takes the 3 sampled feature sets of the anchor's own width
(the reference hard-codes 64 = mid_channels); its best-keyframe score is
repeated over each s x s block; the FTT head normalises the coefficients
over the spatial blocks, per channel; the crop after the inverse DCT takes
the DCT padding off (``ops.dct.pad_images_for_dct`` keeps its quirks).
:class:`FTTALayer` groups its channels by gcd(channel, 64) by default,
the JAX package's workaround for the reference's 144-channel layer, which
crashes (``freq_groups=64`` is the reference's layout, for widths it
divides).  Its LayerNorms take flax's epsilon, 1e-6.  Time runs as a
Python loop; the upsampler, the FTT features and the first attention of
each FTT step (which the carried feature does not enter) run all frames as
one batch.  H and W are at least 64 (SPyNet, at the input's size, needs
a coarsest level of 2 pixels), and multiples of 16 for FTVSR (the FTT's
8x8 patches of its 1/8 DCT grid) and of 4 for TTVSR (LTAM's blocks); the
JAX package fails at the same shapes.  Modules take and return
channels-last tensors inside; the models take and return (B, T, 3, H,
W).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dct import (adaptive_avg_pool, block_dct, block_idct,
                       depth_to_space, pad_images_for_dct, patch_grid,
                       resize_flow, space_to_depth)
from ..ops.resize import resize_bilinear
from ..ops.warp import flow_warp, grid_sample_nearest
from .basicvsr import MMPixelShufflePack, MMResidualBlocksWithInputConv
from .blocks import Conv2d
from .spynet import SpyNet

__all__ = ["FTVSRNet", "TTVSRNet", "LTAM", "FTTALayer", "FTTEncoder"]

FTT_CHANNELS = 144  # the FTT head's width (restorers/ftvsr.py)
DCT_CHANNELS = 3 * 64  # an RGB frame's 8x8 DCT coefficients


def _l2norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True) \
        .clamp_min(1e-12)


class LTAM(nn.Module):
    """Location-aware sparse temporal attention.  ``forward(curr_feat,
    index_set, anchor_feat, s123, location)``: the current frame's features
    and the anchor (B, H, W, C); the keyframes' space-to-depth features
    ``index_set`` (B, T, H/s, W/s, C*s*s) and their three cross-scale sets
    side by side, ``s123`` (B, T, H/s, W/s, 3*C*s*s); the block
    coordinates (x, y) each keyframe's trajectory reached, ``location``
    (B, T, H/s, W/s, 2).  Each block takes the keyframe whose (nearest-)
    sampled index features are closest in cosine to its own, fuses that
    keyframe's three sets by a 3x3 conv, scales them by the score and adds
    the anchor."""

    def __init__(self, stride: int = 4, channels: int = 64):
        super().__init__()
        self.stride = stride
        self.fusion = Conv2d(3 * channels, channels, 3)

    def _sample(self, buf, location):
        """``buf`` (B, T, hb, wb, D) at each keyframe's nearest tracked
        block."""
        b, t, hb, wb, d = buf.shape
        return grid_sample_nearest(
            buf.reshape(b * t, hb, wb, d),
            location[..., 0].reshape(b * t, hb * wb),
            location[..., 1].reshape(b * t, hb * wb)).reshape(b, t, hb, wb, d)

    def scores(self, curr_feat, index_set, location):
        """The cosine score of each keyframe at each block, (B, T, hb,
        wb): the block's pick is the first keyframe of the highest."""
        q = _l2norm(space_to_depth(curr_feat, self.stride), -1)
        k = _l2norm(self._sample(index_set, location), -1)
        return torch.einsum("bthwd,bhwd->bthw", k, q)

    def forward(self, curr_feat, index_set, anchor_feat, s123, location):
        b, h, w, _ = anchor_feat.shape
        s = self.stride
        hb, wb = h // s, w // s
        corr = self.scores(curr_feat, index_set, location)
        corr_soft = corr.amax(1)                              # (B,hb,wb)
        corr_idx = corr.argmax(1)                             # the first max
        sets = self._sample(s123, location)
        best = torch.gather(sets, 1, corr_idx[:, None, :, :, None].expand(
            b, 1, hb, wb, sets.shape[-1]))[:, 0]
        out = self.fusion(depth_to_space(best, s))            # (B,H,W,C)
        soft = corr_soft.repeat_interleave(s, 1).repeat_interleave(s, 2)
        return out * soft[..., None] + anchor_feat


class FTTALayer(nn.Module):
    """Multi-head attention over patch tokens of a frequency map.

    (B, H, W, C) q, k, v -> (B, H, W, C).  The channels split into
    ``freq_groups`` groups (None: gcd(channel, 64)); each group's p x p
    patches are tokens of (C / groups) * p * p values, embedded to
    ``d_model`` by ``layer_q``/``layer_k``/``layer_v``, attended by ``mha``
    (torch's packed input projection, q, k, v in order, and ``out_proj``),
    then residual with the value tokens, LayerNorm, a leaky-relu linear
    with a residual, LayerNorm, and ``linear2`` back to patch values."""

    def __init__(self, channel: int = 144, d_model: int = 144,
                 n_heads: int = 8, patch: int = 8,
                 freq_groups: Optional[int] = None):
        super().__init__()
        groups = math.gcd(channel, 64) if freq_groups is None else freq_groups
        if channel % groups:
            raise ValueError(
                f"channel {channel} not divisible by freq_groups {groups}: "
                "this is the reference FTTA defect; use freq_groups=None for "
                "the gcd workaround")
        self.groups, self.patch = groups, patch
        inpl = channel // groups * patch * patch
        self.layer_q = nn.Linear(inpl, d_model)
        self.layer_k = nn.Linear(inpl, d_model)
        self.layer_v = nn.Linear(inpl, d_model)
        self.mha = nn.MultiheadAttention(d_model, n_heads, batch_first=True)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.linear1 = nn.Linear(d_model, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.linear2 = nn.Linear(d_model, inpl)

    def _tokens(self, x):
        b, h, w, c = x.shape
        g = self.groups
        xg = x.reshape(b, h, w, g, c // g).permute(0, 3, 1, 2, 4)
        pt = space_to_depth(xg.reshape(b * g, h, w, c // g), self.patch)
        return pt.reshape(b, -1, pt.shape[-1])

    def forward(self, q, k, v):
        b, h, w, c = q.shape
        g, p = self.groups, self.patch
        qe = self.layer_q(self._tokens(q))
        ke = self.layer_k(self._tokens(k))
        ve = self.layer_v(self._tokens(v))
        out = self.mha(qe, ke, ve, need_weights=False)[0]
        out = self.norm1(out + ve)
        out = self.norm2(F.leaky_relu(self.linear1(out), 0.1) + out)
        out = self.linear2(out)
        out = depth_to_space(out.reshape(b * g, h // p, w // p, -1), p)
        out = out.reshape(b, g, h, w, c // g).permute(0, 2, 3, 1, 4)
        return out.reshape(b, h, w, c)


class FTTEncoder(nn.Module):
    """A stack of FTTA layers: v = layer 0(q, k, v), then v = layer i(k, v,
    v)."""

    def __init__(self, channel: int = 192, d_model: int = 144,
                 n_heads: int = 8, num_layer: int = 3,
                 freq_groups: Optional[int] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            FTTALayer(channel, d_model, n_heads, freq_groups=freq_groups)
            for _ in range(num_layer))

    def forward(self, q, k, v):
        v = self.layers[0](q, k, v)
        for layer in self.layers[1:]:
            v = layer(k, v, v)
        return v


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


class FTVSRNet(nn.Module):
    """(B, T, 3, H, W) in [0, 1] -> (B, T, 3, 4H, 4W).  The defaults are
    the reference FTVSR's (64 channels, 72 residual blocks, LTAM blocks of
    4, a keyframe every 3 frames, FTT at d_model 144 with 8 heads);
    ``with_ftt=False`` is TTVSR's head."""

    def __init__(self, mid_channels: int = 64, num_blocks: int = 72,
                 stride: int = 4, keyframe_stride: int = 3,
                 d_model: int = 144, n_heads: int = 8, with_ftt: bool = True):
        super().__init__()
        mid = mid_channels
        self.mid_channels, self.stride = mid, stride
        self.keyframe_stride, self.with_ftt = keyframe_stride, with_ftt
        self.spynet = SpyNet()
        self.feat_extractor = MMResidualBlocksWithInputConv(3, mid, 5)
        self.LTAM = LTAM(stride, mid)
        self.resblocks = MMResidualBlocksWithInputConv(2 * mid, mid,
                                                       num_blocks)
        self.fusion = Conv2d(3 * mid, mid, 1)
        self.upsample1 = MMPixelShufflePack(mid, mid, 2, 3)
        self.upsample2 = MMPixelShufflePack(mid, 64, 2, 3)
        self.conv_hr = Conv2d(64, 64, 3)
        self.conv_last = Conv2d(64, 3, 3)
        if with_ftt:
            c = FTT_CHANNELS
            self.conv_layer1 = Conv2d(DCT_CHANNELS, c, 1)
            self.ftt_feat = MMResidualBlocksWithInputConv(c, c, 3)
            self.ftt_res = MMResidualBlocksWithInputConv(2 * c, c, 3)
            self.ftta = FTTALayer(c, d_model, n_heads)
            self.ftt_fusion0 = Conv2d(3 * c, c, 1)
            self.ftt_fusion1 = Conv2d(c, c, 1)
            self.conv_layer2 = Conv2d(c, DCT_CHANNELS, 1)

    def _flows(self, frames):
        """(forward, backward) flows between neighbours of (B, T, H, W, 3):
        each (B, T-1, H, W, 2), every pair one batch."""
        b, t, h, w, c = frames.shape
        ref = frames[:, :-1].reshape(b * (t - 1), h, w, c)
        supp = frames[:, 1:].reshape(b * (t - 1), h, w, c)
        fb = self.spynet(ref, supp).reshape(b, t - 1, h, w, 2)
        ff = self.spynet(supp, ref).reshape(b, t - 1, h, w, 2)
        return ff, fb

    def _cross_scale(self, feat):
        """A keyframe's three feature sets at block granularity, side by
        side: its own blocks, and 1.5x and 2x patches pooled back."""
        h, w = feat.shape[1:3]
        s = self.stride
        f2 = adaptive_avg_pool(patch_grid(feat, int(1.5 * s), s,
                                          int(0.25 * s)), h, w)
        f3 = adaptive_avg_pool(patch_grid(feat, 2 * s, s, s // 2), h, w)
        return torch.cat([space_to_depth(f, s) for f in (feat, f2, f3)], -1)

    def _propagate(self, feats, order, flows, keyframes):
        b, _, h, w, _ = feats.shape
        s = self.stride
        hb, wb = h // s, w // s
        gy, gx = torch.meshgrid(
            torch.arange(hb, dtype=feats.dtype, device=feats.device),
            torch.arange(wb, dtype=feats.dtype, device=feats.device),
            indexing="ij")
        grid0 = torch.stack([gx, gy], -1).expand(b, 1, hb, wb, 2)
        feat_prop = feats.new_zeros((b, h, w, self.mid_channels))
        locations = grid0
        index_sets, scale_sets, outs = [], [], {}
        for step, i in enumerate(order):
            cur = feats[:, i]
            if step > 0:
                flow = flows[step - 1]
                feat_prop = flow_warp(feat_prop, flow, "border")
                n = locations.shape[1]
                flow_s = (adaptive_avg_pool(flow, hb, wb) / s)[:, None] \
                    .expand(b, n, hb, wb, 2).reshape(b * n, hb, wb, 2)
                locations = flow_warp(locations.reshape(b * n, hb, wb, 2),
                                      flow_s, "border", "nearest") \
                    .reshape(b, n, hb, wb, 2)
                kept = len(index_sets)
                feat_prop = self.LTAM(cur, torch.stack(index_sets, 1),
                                      feat_prop, torch.stack(scale_sets, 1),
                                      locations[:, :kept])
                if i in keyframes:
                    locations = torch.cat([locations, grid0], 1)
            feat_prop = self.resblocks(torch.cat([cur, feat_prop], -1))
            outs[i] = feat_prop
            if i in keyframes:
                scale_sets.append(self._cross_scale(feat_prop))
                index_sets.append(space_to_depth(cur, s))
        return [outs[i] for i in range(len(order))]

    def _ftt_propagate(self, hf_fea, hf_att, order, flows):
        prop = hf_fea.new_zeros(hf_fea[:, 0].shape)
        outs = {}
        for step, i in enumerate(order):
            if step > 0:
                prop = flow_warp(prop, flows[step - 1], "border")
                prop = self.ftta(hf_att[:, i], prop, prop)
            prop = self.ftt_res(torch.cat([hf_fea[:, i], prop], -1))
            outs[i] = prop
        return [outs[i] for i in range(len(order))]

    def forward(self, lrs):
        b, t, c, h, w = lrs.shape
        x = lrs.permute(0, 1, 3, 4, 2)                      # (B, T, H, W, C)
        flows_forward, flows_backward = self._flows(x)
        feats = self.feat_extractor(x.reshape(b * t, h, w, c)) \
            .reshape(b, t, h, w, self.mid_channels)
        ks = self.keyframe_stride
        outs_b = self._propagate(
            feats, list(range(t - 1, -1, -1)),
            [flows_backward[:, i] for i in range(t - 2, -1, -1)],
            set(range(t - 1, 0, -ks)))
        outs_f = self._propagate(
            feats, list(range(t)), [flows_forward[:, i] for i in range(t - 1)],
            set(range(0, t, ks)))

        # the upsampling of every frame as one batch
        out = torch.cat([torch.stack(outs_b, 1), feats,
                         torch.stack(outs_f, 1)], -1) \
            .reshape(b * t, h, w, 3 * self.mid_channels)
        out = _lrelu(self.fusion(out))
        out = _lrelu(self.upsample1(out))
        out = _lrelu(self.upsample2(out))
        out = self.conv_last(_lrelu(self.conv_hr(out)))
        bic = resize_bilinear(x.reshape(b * t, h, w, c), 4 * h, 4 * w)
        hf = (out + bic).reshape(b, t, 4 * h, 4 * w, c)
        if not self.with_ftt:
            return hf.permute(0, 1, 4, 2, 3)
        return self._ftt(hf, bic.reshape(b, t, 4 * h, 4 * w, c))

    def _ftt(self, hf, bic):
        """The frequency transformer over the DCT coefficients of the
        recurrent outputs ``hf`` and the bilinear base ``bic`` (B, T, 4H,
        4W, 3) -> (B, T, 3, 4H, 4W)."""
        b, t = hf.shape[:2]
        bic_p, ph, pw = pad_images_for_dct(bic)
        hf_p, _, _ = pad_images_for_dct(hf)
        hh, ww = hf_p.shape[2:4]
        hb, wb = hh // 8, ww // 8
        ff, fb = (resize_flow(f.reshape(b * (t - 1), hh, ww, 2), hb, wb)
                  .reshape(b, t - 1, hb, wb, 2) for f in self._flows(hf_p))

        dct_hf0 = block_dct(hf_p.reshape(b * t, hh, ww, 3))
        dct = torch.cat([block_dct(bic_p.reshape(b * t, hh, ww, 3)),
                         dct_hf0])
        # per channel, over the blocks (the reference's quirk)
        dct = _l2norm(dct.reshape(2 * b * t, hb * wb, DCT_CHANNELS), 1)
        fea = self.ftt_feat(self.conv_layer1(
            dct.reshape(2 * b * t, hb, wb, DCT_CHANNELS)))
        bic_fea, hf_fea = fea[:b * t], fea[b * t:]
        # each step's first attention does not see the carried feature
        hf_att = self.ftta(bic_fea, hf_fea, hf_fea) \
            .reshape(b, t, hb, wb, FTT_CHANNELS)
        hf_fea = hf_fea.reshape(b, t, hb, wb, FTT_CHANNELS)
        back = self._ftt_propagate(
            hf_fea, hf_att, list(range(t - 1, -1, -1)),
            [fb[:, i] for i in range(t - 2, -1, -1)])
        fwd = self._ftt_propagate(hf_fea, hf_att, list(range(t)),
                                  [ff[:, i] for i in range(t - 1)])

        o = torch.cat([torch.stack(back, 1), hf_fea, torch.stack(fwd, 1)], -1)
        o = o.reshape(b * t, hb, wb, 3 * FTT_CHANNELS)
        o = self.ftt_fusion1(_lrelu(self.ftt_fusion0(o)))
        o = self.conv_layer2(o) + dct_hf0
        img = block_idct(o) + hf_p.reshape(b * t, hh, ww, 3)
        img = img[:, :hh - ph, :ww - pw]   # the DCT padding off
        return img.reshape(b, t, hh - ph, ww - pw, 3).permute(0, 1, 4, 2, 3)


def TTVSRNet(**kwargs) -> FTVSRNet:
    """TTVSR: FTVSR's trajectory-attention recurrent core without the FTT
    head, 60 residual blocks by default."""
    kwargs.setdefault("num_blocks", 60)
    return FTVSRNet(with_ftt=False, **kwargs)
