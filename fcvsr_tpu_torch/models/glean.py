"""GLEAN, the generative latent bank (counterpart of
``fcvsr_tpu.models.glean``; mmedit sr_backbones/glean_styleganv2.py, with
the JAX package's parameter names).

An RRDB encoder turns the LR image into latent codes and a pyramid of
features; StyleGAN2's synthesis layers consume the codes and fuse the
encoder's features at each resolution up to the input's; a pixel-shuffle
decoder mixes the encoder's top feature with the generator's features
above the input's size into the output image.  Channels-last inside,
NCHW at the boundary.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .blocks import Conv2d
from .blocks_ext import PixelShufflePack
from .sisr import _RRDB
from .stylegan2 import ModulatedStyleConv, ToRGB, gen_channels

__all__ = ["GLEANStyleGANv2", "RRDBFeatureExtractor"]


class RRDBFeatureExtractor(nn.Module):
    """ESRGAN's trunk without its upsampler: conv, ``num_blocks`` RRDBs, a
    conv, plus the first conv's output."""

    def __init__(self, in_channels: int = 3, mid_channels: int = 64,
                 num_blocks: int = 23, growth_channels: int = 32):
        super().__init__()
        self.num_blocks = num_blocks
        self.conv_first = Conv2d(in_channels, mid_channels, 3)
        for i in range(num_blocks):
            self.add_module(f"rrdb{i}", _RRDB(mid_channels, growth_channels))
        self.conv_body = Conv2d(mid_channels, mid_channels, 3)

    def forward(self, x):
        feat = self.conv_first(x)
        body = feat
        for i in range(self.num_blocks):
            body = getattr(self, f"rrdb{i}")(body)
        return feat + self.conv_body(body)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class GLEANStyleGANv2(nn.Module):
    """(B, 3, in_size, in_size) -> (B, 3, out_size, out_size); any other
    input size raises ``ValueError``."""

    def __init__(self, in_size: int = 32, out_size: int = 256,
                 img_channels: int = 3, rrdb_channels: int = 64,
                 num_rrdbs: int = 23, style_channels: int = 512,
                 channel_multiplier: int = 2):
        super().__init__()
        ch = gen_channels(channel_multiplier)
        self.in_size, self.out_size = in_size, out_size
        self.style_channels = style_channels
        self.log_out = int(math.log2(out_size))
        self.num_styles = self.log_out * 2 - 2
        # the encoder: the RRDB trunk, then a conv, then a stride-2 pair a
        # halving down to 4 px, then the latent codes from the 4 px feature
        self.rrdb_extractor = RRDBFeatureExtractor(img_channels, rrdb_channels,
                                                   num_rrdbs)
        self.enc_first = Conv2d(rrdb_channels, ch[in_size], 3)
        self.encoder_res = [2 ** i for i in range(int(math.log2(in_size)),
                                                  1, -1)]
        cin = ch[in_size]
        for i, res in enumerate(self.encoder_res):
            if res > 4:
                self.add_module(f"enc{i}_0", Conv2d(cin, ch[res // 2], 3, 2))
                self.add_module(f"enc{i}_1", Conv2d(ch[res // 2],
                                                    ch[res // 2], 3))
                cin = ch[res // 2]
            else:
                self.add_module(f"enc{i}_0", Conv2d(cin, ch[res], 3))
                self.add_module(f"enc{i}_latent", nn.Linear(
                    ch[res] * res * res, self.num_styles * style_channels))
        # StyleGAN2's synthesis layers, fused with the encoder's features
        # at every resolution up to the input's
        self.constant_input = nn.Parameter(torch.zeros(1, 4, 4, ch[4]))
        self.g_conv1 = ModulatedStyleConv(ch[4], ch[4], style_channels, 4)
        self.g_to_rgb1 = ToRGB(ch[4], style_channels, img_channels)
        fusion, cin = 0, ch[4]
        for i in range(3, self.log_out + 1):
            res = 2 ** i
            if res // 2 <= in_size:
                self.add_module(f"fusion_out{fusion}",
                                Conv2d(2 * cin, cin, 3))
                self.add_module(f"fusion_skip{fusion}",
                                Conv2d(img_channels + cin, img_channels, 3))
                fusion += 1
            self.add_module(f"g_conv_up{i}", ModulatedStyleConv(
                cin, ch[res], style_channels, res, upsample=True))
            self.add_module(f"g_conv{i}", ModulatedStyleConv(
                ch[res], ch[res], style_channels, res))
            self.add_module(f"g_to_rgb{i}", ToRGB(ch[res], style_channels,
                                                  img_channels))
            cin = ch[res]
        # the decoder: pixel-shuffle steps from the input's size, each
        # joined by the generator's feature of its resolution
        self.decoder_res = [2 ** i for i in range(int(math.log2(in_size)),
                                                  self.log_out + 1)]
        cin = ch[in_size]
        for i, res in enumerate(self.decoder_res):
            if i > 0:
                cin += ch[res]
            if res < out_size:
                self.add_module(f"dec{i}", PixelShufflePack(
                    cin, ch[res * 2], 2, 3))
                cin = ch[res * 2]
            else:
                self.add_module(f"dec{i}_0", Conv2d(cin, 64, 3))
                self.add_module(f"dec{i}_1", Conv2d(64, img_channels, 3))

    def forward(self, lq):
        x = lq.permute(0, 2, 3, 1)
        b, h, w, _ = x.shape
        if h != self.in_size or w != self.in_size:
            raise ValueError(f"input must be {self.in_size}px, got {h}x{w}")

        feat = self.rrdb_extractor(x)
        feat = _lrelu(self.enc_first(feat))
        encoder_features = [feat]
        for i, res in enumerate(self.encoder_res):
            feat = _lrelu(getattr(self, f"enc{i}_0")(feat))
            if res > 4:
                feat = _lrelu(getattr(self, f"enc{i}_1")(feat))
            else:
                feat = getattr(self, f"enc{i}_latent")(feat.reshape(b, -1))
            encoder_features.append(feat)
        # [latent, 4 px, 8 px, ..., in_size px] after the reversal; the
        # features then run small to large, in the generator's order
        encoder_features = encoder_features[::-1]
        latent = encoder_features[0].reshape(b, -1, self.style_channels)
        encoder_features = encoder_features[1:]

        out = self.constant_input.expand(b, -1, -1, -1)
        out = self.g_conv1(out, latent[:, 0])
        skip = self.g_to_rgb1(out, latent[:, 1])
        fusion, idx, generator_features = 0, 1, []
        for i in range(3, self.log_out + 1):
            if out.shape[1] <= self.in_size:
                f = encoder_features[fusion]
                out = getattr(self, f"fusion_out{fusion}")(
                    torch.cat([out, f], -1))
                skip = getattr(self, f"fusion_skip{fusion}")(
                    torch.cat([skip, f], -1))
                fusion += 1
            out = getattr(self, f"g_conv_up{i}")(out, latent[:, idx])
            out = getattr(self, f"g_conv{i}")(out, latent[:, idx + 1])
            skip = getattr(self, f"g_to_rgb{i}")(out, latent[:, idx + 2],
                                                 skip)
            if out.shape[1] > self.in_size:
                generator_features.append(out)
            idx += 2

        hr = encoder_features[-1]
        for i, res in enumerate(self.decoder_res):
            if i > 0:
                hr = torch.cat([hr, generator_features[i - 1]], -1)
            if res < self.out_size:
                hr = getattr(self, f"dec{i}")(hr)
            else:
                hr = _lrelu(getattr(self, f"dec{i}_0")(hr))
                hr = getattr(self, f"dec{i}_1")(hr)
        return hr.permute(0, 3, 1, 2)

    @torch.no_grad()
    def init_seeded(self, generator: torch.Generator) -> None:
        self.constant_input.copy_(torch.randn(self.constant_input.shape,
                                              generator=generator))
