"""StyleGAN2's generator and discriminator, as GLEAN uses them (counterpart
of ``fcvsr_tpu.models.stylegan2``, channels-last, the JAX package's
parameter names and conventions, not mmgen's).

* Equalised learning rate: weights are stored at unit scale and scaled at
  run time by 1 / sqrt(fan_in) (``EqualLinear`` also by ``lr_mul``).
* Modulation folds into the convolution as in the JAX package: the input
  is scaled by the style per sample and channel, one shared weight
  convolves every sample, and demodulation scales the output per sample
  and channel.
* The upsampling modulated conv is the JAX package's 2x lhs-dilated conv
  padded (1, 2) (``F.conv_transpose2d`` with the kernel flipped, stride 2,
  padding 1, output padding 1), then the [1, 3, 3, 1] blur padded (2, 1)
  with gain 4.  ToRGB's skip is zero-inserted and blurred the same way.
  The discriminator's down conv is the blur, then an unpadded stride-2
  conv.  The minibatch-stddev group is ``g = b // (b // min(4, b))``.
* Noise maps are the JAX ``noises`` collection: ``ModulatedStyleConv``
  holds its map as a parameter ``noise`` (1, H, W, 1).  The GAN trainer
  hands every parameter of the generator to its Adam, these maps too, so
  they train as the JAX package's do (its trainer differentiates and
  updates the whole variable dict ``gen.init`` returns; mmgen keeps them
  as fixed buffers).  They start at zero gradient while ``noise_weight``
  is 0.

Weights are OIHW (convs), (out, in) (``EqualLinear``) and NHWC
(``constant_input``); :mod:`..utils.convert` maps the JAX layouts.  The
constructors leave them at zero: ``models.init_weights`` draws them, from
the JAX package's distributions (unit normals, zero biases and noise
weights), through each module's ``init_seeded``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["EqualLinear", "ModulatedStyleConv", "ToRGB",
           "StyleGAN2Generator", "StyleGAN2Discriminator", "gen_channels"]

SQRT2 = math.sqrt(2.0)


def gen_channels(channel_multiplier: int = 2) -> dict:
    cm = channel_multiplier
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm,
            128: 128 * cm, 256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}


_BLUR_K = np.array([1.0, 3.0, 3.0, 1.0])
_BLUR_2D = np.outer(_BLUR_K, _BLUR_K)
_BLUR_2D = _BLUR_2D / _BLUR_2D.sum()


def _blur_kernel(x: torch.Tensor, gain: float) -> torch.Tensor:
    """The depthwise (C, 1, 4, 4) blur of NCHW ``x``'s channels."""
    k = torch.tensor(_BLUR_2D * gain, dtype=x.dtype, device=x.device)
    return k.expand(x.shape[1], 1, 4, 4)


def _blur(x: torch.Tensor, pad: tuple, gain: float = 1.0) -> torch.Tensor:
    """Depthwise 4-tap blur of NCHW ``x``, padded ``pad`` = (lo, hi) on both
    spatial axes (a symmetric kernel: correlation and convolution agree)."""
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(x, _blur_kernel(x, gain), groups=x.shape[1])


def _up_blur(x: torch.Tensor) -> torch.Tensor:
    """Zero insertion to 2H x 2W (x at the even positions), then the blur
    padded (2, 1) with gain 4, of NCHW ``x``: one transposed depthwise
    conv."""
    return F.conv_transpose2d(x, _blur_kernel(x, 4.0), stride=2, padding=1,
                              groups=x.shape[1])


def _normal_(t: torch.Tensor, generator, scale: float = 1.0) -> None:
    t.copy_(torch.randn(t.shape, generator=generator) * scale)


class EqualLinear(nn.Module):
    """Equalised-lr linear: y = x (w / sqrt(fan_in) lr_mul)^T + b lr_mul,
    optionally leaky relu 0.2 times sqrt(2).  ``weight`` (out, in)."""

    def __init__(self, in_features: int, features: int, lr_mul: float = 1.0,
                 use_bias: bool = True, activate: bool = False):
        super().__init__()
        self.lr_mul, self.activate = lr_mul, activate
        self.scale = lr_mul / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        y = x @ (self.weight * self.scale).t()
        if self.bias is not None:
            y = y + self.bias * self.lr_mul
        if self.activate:
            y = F.leaky_relu(y, 0.2) * SQRT2
        return y

    @torch.no_grad()
    def init_seeded(self, generator) -> None:
        _normal_(self.weight, generator, 1.0 / self.lr_mul)
        if self.bias is not None:
            self.bias.zero_()


class _ModulatedConv(nn.Module):
    """Modulated conv: ``weight`` (out, in, k, k), ``style`` the EqualLinear
    from the latent to the input's channels (plus 1), demodulated unless
    ``demodulate`` is False, a 2x upsampling conv with ``upsample``."""

    def __init__(self, in_channels: int, features: int, style_channels: int,
                 kernel_size: int = 3, demodulate: bool = True,
                 upsample: bool = False):
        super().__init__()
        k = kernel_size
        self.demodulate, self.upsample, self.k = demodulate, upsample, k
        self.scale = 1.0 / math.sqrt(in_channels * k * k)
        self.weight = nn.Parameter(torch.zeros(features, in_channels, k, k))
        self.style = EqualLinear(style_channels, in_channels)

    def forward(self, x, style):
        """x (B, H, W, Cin), style (B, S) -> (B, H', W', Cout)."""
        s = self.style(style) + 1.0                        # (B, Cin)
        w = self.weight * self.scale
        xs = (x * s[:, None, None, :]).permute(0, 3, 1, 2)
        if self.upsample:
            y = F.conv_transpose2d(xs, w.flip(2, 3).transpose(0, 1),
                                   stride=2, padding=1, output_padding=1)
            y = _blur(y, (2, 1), gain=4.0)
        else:
            y = F.conv2d(xs, w, padding=self.k // 2)
        y = y.permute(0, 2, 3, 1)
        if self.demodulate:
            # sum over (in, k, k) of (w s)^2 = sum_ci s^2 sum_k w^2
            w2 = (w * w).sum((2, 3))                       # (Cout, Cin)
            demod = torch.rsqrt((s * s) @ w2.t() + 1e-8)   # (B, Cout)
            y = y * demod[:, None, None, :]
        return y

    @torch.no_grad()
    def init_seeded(self, generator) -> None:
        _normal_(self.weight, generator)


class ModulatedStyleConv(nn.Module):
    """Modulated conv, plus ``noise_weight`` times the noise map, plus the
    bias, leaky relu 0.2 times sqrt(2).  ``size`` is the output's side
    (the noise map's)."""

    def __init__(self, in_channels: int, features: int, style_channels: int,
                 size: int, kernel_size: int = 3, upsample: bool = False):
        super().__init__()
        self.conv = _ModulatedConv(in_channels, features, style_channels,
                                   kernel_size, upsample=upsample)
        self.noise_weight = nn.Parameter(torch.zeros(()))
        self.noise = nn.Parameter(torch.zeros(1, size, size, 1))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, style, noise=None):
        y = self.conv(x, style)
        y = y + self.noise_weight * (self.noise if noise is None else noise)
        return F.leaky_relu(y + self.bias, 0.2) * SQRT2

    @torch.no_grad()
    def init_seeded(self, generator) -> None:
        self.noise_weight.zero_()
        self.bias.zero_()
        _normal_(self.noise, generator)


class ToRGB(nn.Module):
    """1x1 modulated conv (no demodulation) to the image's channels, plus
    the bias and the upsampled skip."""

    def __init__(self, in_channels: int, style_channels: int,
                 out_channels: int = 3):
        super().__init__()
        self.conv = _ModulatedConv(in_channels, out_channels, style_channels,
                                   1, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, style, skip=None):
        y = self.conv(x, style) + self.bias
        if skip is not None:
            y = y + _up_blur(skip.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return y

    @torch.no_grad()
    def init_seeded(self, generator) -> None:
        self.bias.zero_()


class StyleGAN2Generator(nn.Module):
    """Style mapping (``num_mlps`` EqualLinears) and synthesis network:
    (B, style_channels) -> (B, out_size, out_size, out_channels)."""

    def __init__(self, out_size: int = 256, style_channels: int = 512,
                 num_mlps: int = 8, channel_multiplier: int = 2,
                 lr_mlp: float = 0.01, out_channels: int = 3):
        super().__init__()
        ch = gen_channels(channel_multiplier)
        self.log_size = int(math.log2(out_size))
        self.num_latents = self.log_size * 2 - 2
        for i in range(num_mlps):
            self.add_module(f"mlp{i}", EqualLinear(
                style_channels, style_channels, lr_mul=lr_mlp, activate=True))
        self.num_mlps = num_mlps
        self.constant_input = nn.Parameter(torch.zeros(1, 4, 4, ch[4]))
        self.conv1 = ModulatedStyleConv(ch[4], ch[4], style_channels, 4)
        self.to_rgb1 = ToRGB(ch[4], style_channels, out_channels)
        in_ch = ch[4]
        for i in range(3, self.log_size + 1):
            out_ch = ch[2 ** i]
            self.add_module(f"conv_up{i}", ModulatedStyleConv(
                in_ch, out_ch, style_channels, 2 ** i, upsample=True))
            self.add_module(f"conv{i}", ModulatedStyleConv(
                out_ch, out_ch, style_channels, 2 ** i))
            self.add_module(f"to_rgb{i}", ToRGB(out_ch, style_channels,
                                                out_channels))
            in_ch = out_ch

    def map_style(self, z):
        x = z / torch.clamp(torch.sqrt((z * z).mean(-1, keepdim=True)),
                            min=1e-8)
        for i in range(self.num_mlps):
            x = getattr(self, f"mlp{i}")(x)
        return x

    def forward(self, z, input_is_latent: bool = False):
        latent = z if input_is_latent else self.map_style(z)
        out = self.constant_input.expand(z.shape[0], -1, -1, -1)
        out = self.conv1(out, latent)
        skip = self.to_rgb1(out, latent)
        for i in range(3, self.log_size + 1):
            out = getattr(self, f"conv_up{i}")(out, latent)
            out = getattr(self, f"conv{i}")(out, latent)
            skip = getattr(self, f"to_rgb{i}")(out, latent, skip)
        return skip

    @torch.no_grad()
    def init_seeded(self, generator) -> None:
        _normal_(self.constant_input, generator)


class _EqualConv(nn.Module):
    """The discriminator's equalised-lr conv (``weight`` OIHW at unit
    scale, ``bias`` unless None), optionally blurred then strided by 2."""

    def __init__(self, cin: int, cout: int, k: int, down: bool = False,
                 bias: bool = True):
        super().__init__()
        self.k, self.down = k, down
        self.scale = 1.0 / math.sqrt(cin * k * k)
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        """NCHW in and out."""
        w = self.weight * self.scale
        if self.down:
            # blur pad p = (4 - 2) + (k - 1), split hi / lo
            p = 2 + (self.k - 1)
            return F.conv2d(_blur(x, ((p + 1) // 2, p // 2)), w, stride=2)
        return F.conv2d(x, w, padding=self.k // 2)

    @torch.no_grad()
    def init_seeded(self, generator) -> None:
        _normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()


def _act(conv: _EqualConv, x):
    return F.leaky_relu(conv(x) + conv.bias[:, None, None], 0.2) * SQRT2


class StyleGAN2Discriminator(nn.Module):
    """Residual discriminator with minibatch stddev:
    (B, in_size, in_size, C) -> (B, 1) logits."""

    def __init__(self, in_size: int = 256, channel_multiplier: int = 2,
                 in_channels: int = 3, mbstd_group: int = 4):
        super().__init__()
        ch = gen_channels(channel_multiplier)
        self.log_size = int(math.log2(in_size))
        self.mbstd_group = mbstd_group
        self.from_rgb = _EqualConv(in_channels, ch[in_size], 1)
        cin = ch[in_size]
        for i in range(self.log_size, 2, -1):
            out_ch = ch[2 ** (i - 1)]
            self.add_module(f"skip{i}", _EqualConv(cin, out_ch, 1, bias=False))
            self.add_module(f"conv{i}_1", _EqualConv(cin, ch[2 ** i], 3))
            self.add_module(f"conv{i}_2", _EqualConv(ch[2 ** i], out_ch, 3,
                                                     down=True))
            cin = out_ch
        self.final_conv = _EqualConv(cin + 1, ch[4], 3)
        self.final_linear1 = EqualLinear(ch[4] * 16, ch[4], activate=True)
        self.final_linear2 = EqualLinear(ch[4], 1)

    def forward(self, x):
        y = _act(self.from_rgb, x.permute(0, 3, 1, 2))
        for i in range(self.log_size, 2, -1):
            skip_conv = getattr(self, f"skip{i}")
            skip = F.conv2d(_blur(y, (1, 1)),
                            skip_conv.weight * skip_conv.scale, stride=2)
            y = _act(getattr(self, f"conv{i}_1"), y)
            y = _act(getattr(self, f"conv{i}_2"), y)
            y = (y + skip) / SQRT2
        y = y.permute(0, 2, 3, 1)
        # minibatch stddev over groups of g samples
        b, h, w, c = y.shape
        g = min(self.mbstd_group, b)
        g = b // (b // g)
        grp = y.reshape(g, b // g, h, w, c)
        std = torch.sqrt(grp.var(0, correction=0) + 1e-8).mean(
            (1, 2, 3), keepdim=True)
        y = torch.cat([y, std.repeat(g, h, w, 1)], -1)
        y = _act(self.final_conv, y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.final_linear1(y.reshape(b, -1))
        return self.final_linear2(y)
