"""TTSR, the texture transformer for reference-based SR (counterpart of
``fcvsr_tpu.models.ttsr``; reference sr_backbones/ttsr_net.py,
extractors/lte.py and transformers/search_transformer.py).

``LTE`` extracts VGG19-shaped texture features at three levels; the
``SearchTransformer`` finds, for each 3x3 patch of the upsampled LR's
level-3 features, the most relevant patch of the down-and-up sampled
reference's (normalised patches, one float32 product with TF32 off, as the
JAX package's ``Precision.HIGHEST``; the first maximum, as ``jnp.argmax``
takes it), and transfers the reference's patches at each level (torch's
channel-major unfold, an overlap-add fold divided by 9); ``TTSRNet`` fuses
the textures into a x4 SR through cross-scale feature integration.  The
LTE's weights start random (seeded); the modules keep the JAX package's
names.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bicubic
from .basicvsr import MMPixelShufflePack
from .blocks import Conv2d

__all__ = ["LTE", "SearchTransformer", "TTSRNet", "TTSR"]

_VGG_MEAN = (0.485, 0.456, 0.406)
_VGG_STD = (0.229, 0.224, 0.225)


def _max_pool2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class LTE(nn.Module):
    """The learnable texture extractor, VGG19's first 3 stages (lte.py:13-90).
    (B, H, W, 3) in [0, ``pixel_range``] -> [level 3 (256 channels, /4),
    level 2 (128, /2), level 1 (64, /1)]."""

    def __init__(self, pixel_range: float = 1.0):
        super().__init__()
        self.register_buffer("mean", torch.tensor(_VGG_MEAN) * pixel_range,
                             persistent=False)
        self.register_buffer("std", torch.tensor(_VGG_STD) * pixel_range,
                             persistent=False)
        self.conv1_1 = Conv2d(3, 64, 3)
        self.conv1_2 = Conv2d(64, 64, 3)
        self.conv2_1 = Conv2d(64, 128, 3)
        self.conv2_2 = Conv2d(128, 128, 3)
        self.conv3_1 = Conv2d(128, 256, 3)

    def forward(self, x):
        x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        lv1 = F.relu(self.conv1_1(x))
        x = _max_pool2(F.relu(self.conv1_2(lv1)))
        lv2 = F.relu(self.conv2_1(x))
        x = _max_pool2(F.relu(self.conv2_2(lv2)))
        lv3 = F.relu(self.conv3_1(x))
        return [lv3, lv2, lv1]


def _unfold(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, L, C*k*k) patch rows, torch's channel-major order
    (c*k*k + ky*k + kx)."""
    cols = F.unfold(x.permute(0, 3, 1, 2), k, padding=pad, stride=stride)
    return cols.transpose(1, 2)


def _fold(patches: torch.Tensor, out_hw, k: int, stride: int,
          pad: int) -> torch.Tensor:
    """Overlap-add inverse of :func:`_unfold` (``F.fold``): (B, L, C*k*k)
    -> (B, H, W, C)."""
    out = F.fold(patches.transpose(1, 2), tuple(out_hw), k, padding=pad,
                 stride=stride)
    return out.permute(0, 2, 3, 1)


def _relevance(key: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """key (B, K, D) @ query (B, Q, D)^T in float32 with TF32 off on the
    card, whatever the process's setting."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.bmm(key, query.transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


class SearchTransformer(nn.Module):
    """Relevance embedding and hard / soft attention
    (search_transformer.py); no parameters."""

    def forward(self, lq_up, ref_downup, refs, return_index: bool = False):
        """lq_up, ref_downup: (B, H, W, C); refs: [(B, H, W, C), (B, 2H, 2W,
        C/2), (B, 4H, 4W, C/4)], channels-last.  Returns (the soft attention
        (B, H, W, 1), the textures, shaped as refs), and with
        ``return_index`` the hard attention's picks (B, H*W) too."""
        b, h, w, _ = lq_up.shape
        query = F.normalize(_unfold(lq_up, 3, 1, 1), dim=-1, eps=1e-12)
        key = F.normalize(_unfold(ref_downup, 3, 1, 1), dim=-1, eps=1e-12)
        rel = _relevance(key, query)                   # (B, K, Q)
        max_val = rel.amax(dim=1)
        max_idx = torch.argmax(rel, dim=1)             # the first maximum
        textures = []
        for i, ref in enumerate(refs):
            s = 2 ** i
            vals = _unfold(ref, 3 * s, s, s)           # (B, HW, C k k)
            got = torch.gather(vals, 1, max_idx.unsqueeze(-1).expand(
                -1, -1, vals.shape[-1]))
            textures.append(_fold(got, (h * s, w * s), 3 * s, s, s) / 9.0)
        soft = max_val.reshape(b, h, w, 1)
        if return_index:
            return soft, textures, max_idx
        return soft, textures


def _up_bicubic(x, factor):
    return resize_bicubic(x, x.shape[1] * factor, x.shape[2] * factor)


def _res_blocks(owner: nn.Module, name: str, n: int, c: int) -> None:
    """``n`` conv - relu - conv residual blocks on ``owner``, under the JAX
    package's flat names ``{name}_b{i}_conv1`` / ``_conv2``."""
    for i in range(n):
        owner.add_module(f"{name}_b{i}_conv1", Conv2d(c, c, 3))
        owner.add_module(f"{name}_b{i}_conv2", Conv2d(c, c, 3))


class TTSRNet(nn.Module):
    """The main texture-transformer SR net (ttsr_net.py:228-439),
    channels-last: x (B, H, W, in), the soft attention (B, H, W, 1) and the
    textures [(B, H, W, 4t), (B, 2H, 2W, 2t), (B, 4H, 4W, t)] -> (B, 4H,
    4W, out), clipped to [-1, 1]."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 mid_channels: int = 64, texture_channels: int = 64,
                 num_blocks: Sequence[int] = (16, 16, 8, 4),
                 res_scale: float = 1.0):
        super().__init__()
        c, t = mid_channels, texture_channels
        self.num_blocks, self.res_scale = tuple(num_blocks), res_scale
        nb = self.num_blocks
        convs = {
            "sfe_first": (in_channels, c, 3), "sfe_last": (c, c, 3),
            "conv_first1": (c + 4 * t, c, 3), "conv_last1": (c, c, 3),
            "conv_first2": (c + 2 * t, c, 3),
            "csfi2_1to2": (c, c, 1), "csfi2_2to1": (c, c, 3, 2),
            "csfi2_merge1": (2 * c, c, 3), "csfi2_merge2": (2 * c, c, 3),
            "conv_last2_1": (c, c, 3), "conv_last2_2": (c, c, 3),
            "conv_first3": (c + t, c, 3),
            "csfi3_1to2": (c, c, 1), "csfi3_1to4": (c, c, 1),
            "csfi3_2to1": (c, c, 3, 2), "csfi3_2to4": (c, c, 1),
            "csfi3_4to1_1": (c, c, 3, 2), "csfi3_4to1_2": (c, c, 3, 2),
            "csfi3_4to2": (c, c, 3, 2),
            "csfi3_merge1": (3 * c, c, 3), "csfi3_merge2": (3 * c, c, 3),
            "csfi3_merge4": (3 * c, c, 3),
            "conv_last3_1": (c, c, 3), "conv_last3_2": (c, c, 3),
            "conv_last3_3": (c, c, 3),
            "merge_1to4": (c, c, 1), "merge_2to4": (c, c, 1),
            "merge_conv": (3 * c, c, 3), "merge_last1": (c, c // 2, 3),
            "merge_last2": (c // 2, out_channels, 1)}
        for name, args in convs.items():
            self.add_module(name, Conv2d(*args))
        for name, n in (("sfe", nb[0]), ("rb1", nb[1]), ("rb2_1", nb[2]),
                        ("rb2_2", nb[2]), ("rb3_1", nb[3]), ("rb3_2", nb[3]),
                        ("rb3_3", nb[3])):
            _res_blocks(self, name, n, c)
        self.up1 = MMPixelShufflePack(c, c, 2, 3)
        self.up2 = MMPixelShufflePack(c, c, 2, 3)

    def _res(self, x, name: str, n: int):
        for i in range(n):
            out = getattr(self, f"{name}_b{i}_conv1")(x)
            out = getattr(self, f"{name}_b{i}_conv2")(F.relu(out))
            x = x + out * self.res_scale
        return x

    def forward(self, x, soft_attention, textures):
        nb = self.num_blocks
        relu = F.relu

        # SFE
        x1 = relu(self.sfe_first(x))
        x1 = self.sfe_last(self._res(x1, "sfe", nb[0])) + x1

        # stage 1
        res = self.conv_first1(torch.cat([x1, textures[0]], -1))
        x1 = x1 + res * soft_attention
        x1 = x1 + self.conv_last1(self._res(x1, "rb1", nb[1]))

        # stage 2
        x21 = x1
        x22 = relu(self.up1(x1))
        res = self.conv_first2(torch.cat([x22, textures[1]], -1))
        x22 = x22 + res * _up_bicubic(soft_attention, 2)

        # CSFI2
        x12 = relu(self.csfi2_1to2(_up_bicubic(x21, 2)))
        x21r = relu(self.csfi2_2to1(x22))
        x21r = relu(self.csfi2_merge1(torch.cat([x21, x21r], -1)))
        x22r = relu(self.csfi2_merge2(torch.cat([x22, x12], -1)))
        x21r = self._res(x21r, "rb2_1", nb[2])
        x22r = self._res(x22r, "rb2_2", nb[2])
        x21 = x21 + self.conv_last2_1(x21r)
        x22 = x22 + self.conv_last2_2(x22r)

        # stage 3
        x31, x32 = x21, x22
        x33 = relu(self.up2(x22))
        res = self.conv_first3(torch.cat([x33, textures[2]], -1))
        x33 = x33 + res * _up_bicubic(soft_attention, 4)

        # CSFI3
        x12 = relu(self.csfi3_1to2(_up_bicubic(x31, 2)))
        x14 = relu(self.csfi3_1to4(_up_bicubic(x31, 4)))
        x21r = relu(self.csfi3_2to1(x32))
        x24 = relu(self.csfi3_2to4(_up_bicubic(x32, 2)))
        x41 = relu(self.csfi3_4to1_1(x33))
        x41 = relu(self.csfi3_4to1_2(x41))
        x42 = relu(self.csfi3_4to2(x33))
        x31r = relu(self.csfi3_merge1(torch.cat([x31, x21r, x41], -1)))
        x32r = relu(self.csfi3_merge2(torch.cat([x32, x12, x42], -1)))
        x33r = relu(self.csfi3_merge4(torch.cat([x33, x14, x24], -1)))
        x31r = self._res(x31r, "rb3_1", nb[3])
        x32r = self._res(x32r, "rb3_2", nb[3])
        x33r = self._res(x33r, "rb3_3", nb[3])
        x31 = x31 + self.conv_last3_1(x31r)
        x32 = x32 + self.conv_last3_2(x32r)
        x33 = x33 + self.conv_last3_3(x33r)

        # merge
        x14 = relu(self.merge_1to4(_up_bicubic(x31, 4)))
        x24 = relu(self.merge_2to4(_up_bicubic(x32, 2)))
        out = relu(self.merge_conv(torch.cat([x33, x14, x24], -1)))
        out = self.merge_last2(self.merge_last1(out))
        return out.clamp(-1, 1)


class TTSR(nn.Module):
    """TTSR end to end: LTE features of the x4 bicubic LR, of the reference
    bicubic-downscaled to the LR's size and back, and of the reference;
    the search transformer; the main net.  lq (B, 3, h, w) and ref (B, 3,
    4h, 4w) -> (B, 3, 4h, 4w), as the reference restorer calls it."""

    def __init__(self, mid_channels: int = 64, texture_channels: int = 64,
                 num_blocks: Sequence[int] = (16, 16, 8, 4)):
        super().__init__()
        self.extractor = LTE()
        self.transformer = SearchTransformer()
        self.generator = TTSRNet(mid_channels=mid_channels,
                                 texture_channels=texture_channels,
                                 num_blocks=tuple(num_blocks))

    def search(self, lq, ref):
        """The LR (channels-last) and the search transformer's (soft
        attention, textures, picks)."""
        lq_nhwc = lq.permute(0, 2, 3, 1)
        ref_nhwc = ref.permute(0, 2, 3, 1)
        h, w = lq_nhwc.shape[1:3]
        lq_up = _up_bicubic(lq_nhwc, 4)
        ref_downup = _up_bicubic(resize_bicubic(ref_nhwc, h, w), 4)
        q_feats = self.extractor(lq_up)
        k_feats = self.extractor(ref_downup)
        v_feats = self.extractor(ref_nhwc)
        return (lq_nhwc,) + self.transformer(q_feats[0], k_feats[0], v_feats,
                                             return_index=True)

    def forward(self, lq, ref):
        lq_nhwc, soft, textures, _ = self.search(lq, ref)
        return self.generator(lq_nhwc, soft, textures).permute(0, 3, 1, 2)
