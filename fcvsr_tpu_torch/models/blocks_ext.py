"""Library blocks of ``fcvsr_tpu.models.blocks_ext`` that the port's models
use; the rest stay to be ported.

``PixelShufflePack`` (a conv to ``out_channels * r * r`` channels, then
depth-to-space in torch's channel order) is the zoo's
``MMPixelShufflePack``, under the JAX package's name: its parameters are
``upsample_conv.weight`` / ``.bias`` in both.

The gated blocks (``simple_gate``, ``simple_gate2``, ``RepConv``,
``RepConv2``, ``CAB2``), ``TFDC`` (temporal-frequency difference
compensation) and ``SpaFreqBlock`` (``FourierUnit``, ``SpatialAttention``,
``SKFF``) back FCVSR-TFDC (``models.fcvsr_tfdc``).  Channels-last (B, H,
W, C) throughout; module names are the JAX package's.  The reference's
quirks are kept as the JAX package keeps them:

* ``TFDC``: the reference rebinds ``self.conv2`` while defining conv3..6,
  so branches 1 and 3 share one frequency conv pair, ``conv26`` (one set
  of weights).  Its spectra pack imaginary parts first (norm
  "backward") and unpack the first half as the real part; the inverse
  transform takes ``s=(h, w)``, which matters at odd widths.
* ``FourierUnit``: the SE gate acts on the pooled spectrum and the (B, 1,
  1, C) result is inverse-transformed at ``s=(h, w)``, so only its DC bin
  survives: the output is a per-channel constant image, computed in that
  closed form.  Its spectrum packs real parts first (norm "ortho") and its
  batch norm runs on running statistics (``blocks.BatchNorm2d``).
* ``SKFF`` at height 1 multiplies ``a - b`` by a softmax over one element,
  which is 1: its parameters exist for the ``state_dict``, not the output.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .basicvsr import MMPixelShufflePack as PixelShufflePack
from .blocks import BatchNorm2d, CALayer, Conv2d, LayerNorm2d

__all__ = ["PixelShufflePack", "simple_gate", "simple_gate2", "RepConv",
           "RepConv2", "CAB2", "TFDC", "FourierUnit", "SpatialAttention",
           "SKFF", "SpaFreqBlock"]


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * b


def simple_gate2(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


class RepConv(nn.Module):
    """A k x k and a 3 x 3 grouped conv (``n_feat // 8`` groups, no bias)
    plus the identity."""

    def __init__(self, n_feat: int, kernel_size: int):
        super().__init__()
        g = n_feat // 8
        self.conv_1 = Conv2d(n_feat, n_feat, kernel_size, bias=False,
                             groups=g)
        self.conv_2 = Conv2d(n_feat, n_feat, 3, bias=False, groups=g)

    def forward(self, x):
        return self.conv_1(x) + self.conv_2(x) + x


class RepConv2(nn.Module):
    """A depthwise 3 x 3 conv plus the identity."""

    def __init__(self, n_feat: int):
        super().__init__()
        self.conv_2 = Conv2d(n_feat, n_feat, 3, bias=False, groups=n_feat)

    def forward(self, x):
        return self.conv_2(x) + x


class CAB2(nn.Module):
    """The NAFNet-style gated block with ``add_channel`` auxiliary channels:
    the input is (n_feat + add_channel) wide; the auxiliary ones pass a
    depthwise conv, the whole is layer-normed, expanded, gated (RepConv2,
    ``simple_gate``, RepConv, expand2, ``simple_gate2``), channel-attended
    and projected, and added to the first ``n_feat`` channels scaled by a
    learned ``beta`` (zero at init: the block starts as the identity)."""

    def __init__(self, n_feat: int, add_channel: int, kernel_size: int = 5,
                 reduction: int = 4):
        super().__init__()
        n = n_feat
        self.n_feat = n
        self.beta = nn.Parameter(torch.zeros(n))
        self.conv1 = Conv2d(add_channel, add_channel, 3, bias=False,
                            groups=add_channel)
        self.norm = LayerNorm2d(n + add_channel)
        self.expand = Conv2d(n + add_channel, 2 * n, 1, bias=False)
        self.rep2 = RepConv2(2 * n)
        self.rep = RepConv(n, kernel_size)
        self.expand2 = Conv2d(n, 2 * n, 1, bias=False)
        self.CA2 = CALayer(n, reduction)
        self.project = Conv2d(n, n, 1, bias=False)

    def forward(self, x):
        shortcut, aux = x[..., :self.n_feat], x[..., self.n_feat:]
        res = torch.cat([shortcut, self.conv1(aux)], -1)
        res = self.expand(self.norm(res))
        res = self.rep(simple_gate(self.rep2(res)))
        res = simple_gate2(self.expand2(res))
        res = self.project(self.CA2(res))
        return shortcut + res * self.beta.to(x.dtype)


class _ConvPair(nn.Module):
    """conv - relu - conv, k x k, no bias."""

    def __init__(self, feats: int, k: int):
        super().__init__()
        self.c0 = Conv2d(feats, feats, k, bias=False)
        self.c1 = Conv2d(feats, feats, k, bias=False)

    def forward(self, x):
        return self.c1(torch.relu(self.c0(x)))


class TFDC(nn.Module):
    """Temporal-frequency difference compensation: (B, H, W, 3 dim) ->
    (B, H, W, dim).  Three branches (feature convs of k 1, 3 and 5) take
    each third's spectrum, gate the centre's by the sigmoid of a conv pair
    over its differences to the other two, return to space through the
    shared ``CAB2``; ``conv8`` fuses the branches, plus the centre third."""

    def __init__(self, dim: int):
        super().__init__()
        d = dim
        self.dim = d
        self.conv1 = _ConvPair(d, 1)
        self.conv3 = _ConvPair(d, 3)
        self.conv5 = _ConvPair(d, 5)
        self.conv4 = _ConvPair(2 * d, 3)
        self.conv26 = _ConvPair(2 * d, 5)   # branches 1 and 3 share it
        self.CAB2 = CAB2(d // 2, add_channel=d // 2, kernel_size=5,
                         reduction=4)
        self.conv8 = Conv2d(3 * (d // 2), d, 3, bias=False)

    @staticmethod
    def _pack(v):
        f = torch.fft.rfft2(v.float(), dim=(1, 2), norm="backward")
        return torch.cat([f.imag, f.real], -1).to(v.dtype)

    @staticmethod
    def _unpack(v, h: int, w: int):
        re, im = v.float().chunk(2, dim=-1)
        out = torch.fft.irfft2(torch.complex(re, im), s=(h, w), dim=(1, 2),
                               norm="backward")
        return out.to(v.dtype)

    def _branch(self, x, feat_conv, freq_conv):
        d = self.dim
        f1, f2, f3 = (self._pack(feat_conv(x[..., i * d:(i + 1) * d]))
                      for i in range(3))
        d21 = f1 - f2
        d23 = f3 - f2
        gate_f = torch.sigmoid(freq_conv(d21 + freq_conv(d21)))
        gate_b = torch.sigmoid(freq_conv(d23 + freq_conv(d23)))
        out = f2 * gate_f + f2 * gate_b + f2
        return self.CAB2(self._unpack(out, x.shape[1], x.shape[2]))

    def forward(self, x):
        d = self.dim
        o1 = self._branch(x, self.conv1, self.conv26)
        o3 = self._branch(x, self.conv3, self.conv4)
        o5 = self._branch(x, self.conv5, self.conv26)
        return self.conv8(torch.cat([o1, o3, o5], -1)) + x[..., d:2 * d]


class FourierUnit(nn.Module):
    """The Fourier SE gate: a per-channel constant image, the DC bin of the
    inverse transform of the gated pooled spectrum (closed form)."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.channels = c
        self.conv_layer = Conv2d(2 * c, 2 * c, 1, bias=False)
        self.bn = BatchNorm2d(2 * c, eps=1e-5, momentum=0.1)
        self.se_down = Conv2d(2 * c, c, 1, bias=False)
        self.se_up = Conv2d(c, 2 * c, 1, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        f = torch.fft.rfftn(x.float(), s=(h, w), dim=(1, 2), norm="ortho")
        ff = torch.cat([f.real, f.imag], -1).to(x.dtype)
        ff = torch.relu(self.bn(self.conv_layer(ff)))
        pooled = ff.mean((1, 2), keepdim=True)
        se = torch.sigmoid(self.se_up(torch.relu(self.se_down(pooled))))
        # irfftn(s=(h, w)) of a (1, 1) spectrum keeps its DC bin alone
        const = se[:, 0, 0, :c] / torch.sqrt(
            torch.tensor(float(h * w), dtype=x.dtype, device=x.device))
        return const[:, None, None, :].expand(b, h, w, c)


class SpatialAttention(nn.Module):
    """The channels' max and mean, a 7 x 7 conv, a sigmoid gate."""

    def __init__(self):
        super().__init__()
        self.spatial = Conv2d(2, 1, 7)

    def forward(self, x):
        pooled = torch.cat([x.amax(-1, keepdim=True),
                            x.mean(-1, keepdim=True)], -1)
        return x * torch.sigmoid(self.spatial(pooled))


class SKFF(nn.Module):
    """Selective kernel fusion at height 1: ``feats[0] - feats[1]``.  Its
    SE convs (``conv_du``, ``fc0``) only scale that by a softmax over one
    element, 1, so the forward does not run them."""

    def __init__(self, in_channels: int, reduction: int = 8):
        super().__init__()
        d = max(in_channels // reduction, 4)
        self.conv_du = Conv2d(in_channels, d, 1, bias=False)
        self.fc0 = Conv2d(d, in_channels, 1, bias=False)

    def forward(self, feats):
        return feats[0] - feats[1]


class SpaFreqBlock(nn.Module):
    """Four rounds of a Fourier gate and a spatial attention, each round's
    two fused by ``SKFF`` and fed to the next; plus the input."""

    def __init__(self, dim: int):
        super().__init__()
        for i in range(4):
            self.add_module(f"fu{i}", FourierUnit(dim))
            self.add_module(f"sa{i}", SpatialAttention())
            self.add_module(f"skff{i}", SKFF(dim))

    def forward(self, x):
        freq = spa = x
        out = None
        for i in range(4):
            fin = freq if out is None else freq + out
            sin = spa if out is None else spa + out
            freq = getattr(self, f"fu{i}")(fin)
            spa = getattr(self, f"sa{i}")(sin)
            out = getattr(self, f"skff{i}")([freq, spa])
        return out + x
