"""The JAX package's block library (``fcvsr_tpu.models.blocks_ext``):
gated conv blocks, FFT attention, shift encoders, temporal-frequency
difference compensation and U-Net parts.  Channels-last (B, H, W, C)
throughout; module names are the JAX package's, so
``utils.convert.block_state_dict_from_jax`` maps its variables onto these
``state_dict`` keys.

``PixelShufflePack`` (a conv to ``out_channels * r * r`` channels, then
depth-to-space in torch's channel order) is the zoo's
``MMPixelShufflePack``, under the JAX package's name: its parameters are
``upsample_conv.weight`` / ``.bias`` in both.

The gated blocks (``simple_gate``, ``simple_gate2``, ``RepConv``,
``RepConv2``, ``CAB2``), ``TFDC`` (temporal-frequency difference
compensation) and ``SpaFreqBlock`` (``FourierUnit``, ``SpatialAttention``,
``SKFF``) back FCVSR-TFDC (``models.fcvsr_tfdc``); the rest (``CAB``,
``CAB1``, ``FSAS``, ``FSAS_freq``, ``FFTSpatialModule``, ``MultiFreqAgg``,
the shift encoders, the U-Net parts) are the library that the reference's
ablations build from.  Where flax infers a conv's input width, torch needs
it: ``ResidualBlocksWithInputConv``, ``ShallowCell`` and ``Encoder2`` take
``in_channels`` first, in mmedit's order.  The reference's quirks are kept
as the JAX package keeps them:

* ``TFDC``: the reference rebinds ``self.conv2`` while defining conv3..6,
  so branches 1 and 3 share one frequency conv pair, ``conv26`` (one set
  of weights).  Its spectra pack imaginary parts first (norm
  "backward") and unpack the first half as the real part; the inverse
  transform takes ``s=(h, w)``, which matters at odd widths.
* ``FFTSpatialModule`` packs its full-frame spectrum real parts first (norm
  "backward"); its inverse takes ``s=(h, w)`` too.
* ``FSAS`` and ``FSAS_freq`` transform 8 x 8 patches in float32, so H and W
  must be multiples of 8; ``FSAS_freq`` reads only the first ``dim``
  channels (the reference ignores its ``conv1`` and the appended shift
  channels) and multiplies ``(qf * kf) * (vf * kf)``.
* ``FourierUnit``: the SE gate acts on the pooled spectrum and the (B, 1,
  1, C) result is inverse-transformed at ``s=(h, w)``, so only its DC bin
  survives: the output is a per-channel constant image, computed in that
  closed form.  Its spectrum packs real parts first (norm "ortho").  Its
  batch norm runs on running statistics (``blocks.BatchNorm2d``); with
  ``train=True`` and the module in training mode it normalises on the
  batch's statistics and updates the running ones as flax does
  (``_BatchStatsNorm2d``).
* ``SKFF`` at height 1 multiplies ``a - b`` by a softmax over one element,
  which is 1: its parameters exist for the ``state_dict``, not the output.
* ``channel_shift`` rolls the flattened (frame, channel) axis of the NCHW
  view across the batch, so a clip's frames are the batch.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import upsample2x_bilinear
from .basicvsr import MMPixelShufflePack as PixelShufflePack
from .blocks import BatchNorm2d, CALayer, Conv2d, LayerNorm2d, PReLU

__all__ = [
    "PixelShufflePack", "SimpleGate", "simple_gate", "simple_gate2",
    "RepConv", "RepConv2", "CAB", "CAB1", "CAB2", "WithBiasLayerNorm",
    "FSAS", "FSAS_freq", "FFTSpatialModule", "TFDC", "FourierUnit",
    "SpatialAttention", "SKFF", "MultiFreqAgg", "SpaFreqBlock",
    "channel_shift", "spatial_shift24", "EncoderShiftBlock",
    "ResidualBlockNoBN", "ResidualBlocksWithInputConv", "SAM", "DownSample",
    "UpSample", "SkipUpSample", "CABEncoder", "CABDecoder", "TFRUNet",
    "ShallowCell", "Encoder2",
]


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * b


def simple_gate2(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)


class SimpleGate(nn.Module):
    """``simple_gate`` (the channel halves' product) or, with ``sigmoid``,
    ``simple_gate2`` (the first half times the sigmoid of the second)."""

    def __init__(self, sigmoid: bool = False):
        super().__init__()
        self.sigmoid = sigmoid

    def forward(self, x):
        return simple_gate2(x) if self.sigmoid else simple_gate(x)


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


class CAB(nn.Module):
    """conv - PReLU - conv (k x k, no bias), channel attention ``CA``, plus
    the input."""

    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 4):
        super().__init__()
        self.body0 = Conv2d(n_feat, n_feat, kernel_size, bias=False)
        self.act = PReLU()
        self.body1 = Conv2d(n_feat, n_feat, kernel_size, bias=False)
        self.CA = CALayer(n_feat, reduction)

    def forward(self, x):
        return self.CA(self.body1(self.act(self.body0(x)))) + x


def _gated(block, res):
    """The gated body of CAB1 and CAB2 on ``res``: layer norm, expand,
    RepConv2, ``simple_gate``, RepConv, expand2, ``simple_gate2``, channel
    attention, projection."""
    res = block.expand(block.norm(res))
    res = block.rep(simple_gate(block.rep2(res)))
    res = simple_gate2(block.expand2(res))
    return block.project(block.CA2(res))


class CAB1(nn.Module):
    """The NAFNet-style gated block (``_gated``), added to the input scaled
    by a learned ``beta`` (zero at init: the block starts as the
    identity)."""

    def __init__(self, n_feat: int, kernel_size: int = 5, reduction: int = 4):
        super().__init__()
        n = n_feat
        self.beta = nn.Parameter(torch.zeros(n))
        self.norm = LayerNorm2d(n)
        self.expand = Conv2d(n, 2 * n, 1, bias=False)
        self.rep2 = RepConv2(2 * n)
        self.rep = RepConv(n, kernel_size)
        self.expand2 = Conv2d(n, 2 * n, 1, bias=False)
        self.CA2 = CALayer(n, reduction)
        self.project = Conv2d(n, n, 1, bias=False)

    def forward(self, x):
        return x + _gated(self, x) * self.beta.to(x.dtype)


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
        res = _gated(self, torch.cat([shortcut, self.conv1(aux)], -1))
        return shortcut + res * self.beta.to(x.dtype)


class WithBiasLayerNorm(LayerNorm2d):
    """Restormer's layer norm over the channels: ``LayerNorm2d`` (the
    biased variance) at eps 1e-5."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)


def _to_patches(x, p: int):
    """(B, H, W, C) -> (B, H / p, W / p, p, p, C)."""
    b, hh, ww, c = x.shape
    if hh % p or ww % p:
        raise ValueError(f"H and W ({hh}, {ww}) must be multiples of the "
                         f"patch size {p}")
    return x.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)


def _from_patches(x):
    b, h, w, p1, p2, c = x.shape
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * p1, w * p2, c)


class FSAS(nn.Module):
    """8 x 8-patch FFT attention: a 1 x 1 and a depthwise 3 x 3 conv give
    q, k and v (2 dim channels each); the inverse transform of q's and k's
    patch spectra multiplied, layer-normed, gates v; a 1 x 1 conv projects
    to dim."""

    def __init__(self, dim: int, patch_size: int = 8):
        super().__init__()
        d = dim
        self.dim = d
        self.patch_size = patch_size
        self.to_hidden = Conv2d(d, d * 6, 1, bias=False)
        self.to_hidden_dw = Conv2d(d * 6, d * 6, 3, bias=False, groups=d * 6)
        self.norm = WithBiasLayerNorm(d * 2)
        self.project_out = Conv2d(d * 2, d, 1, bias=False)

    def _qkv(self, x):
        return self.to_hidden_dw(self.to_hidden(x)).chunk(3, dim=-1)

    def _rfft(self, t):
        return torch.fft.rfft2(_to_patches(t.float(), self.patch_size),
                               dim=(3, 4))

    def _irfft(self, f, dtype):
        p = self.patch_size
        return _from_patches(torch.fft.irfft2(f, s=(p, p), dim=(3, 4))
                             ).to(dtype)

    def forward(self, x):
        q, k, v = self._qkv(x)
        out = self._irfft(self._rfft(q) * self._rfft(k), x.dtype)
        return self.project_out(v * self.norm(out))


class FSAS_freq(FSAS):
    """FSAS on the first ``dim`` of (dim + add_channel) channels that also
    multiplies v's spectrum, ``(qf * kf) * (vf * kf)``; the projection is
    added to those channels, and the appended ones are dropped."""

    def __init__(self, dim: int, add_channel: int, patch_size: int = 8):
        super().__init__(dim, patch_size)
        self.add_channel = add_channel

    def forward(self, x):
        hw = x[..., :self.dim]
        q, k, v = self._qkv(hw)
        kf = self._rfft(k)
        out = self._irfft((self._rfft(q) * kf) * (self._rfft(v) * kf),
                          x.dtype)
        return self.project_out(self.norm(out)) + hw


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class FFTSpatialModule(nn.Module):
    """A spatial branch (3 x 3, 1 x 1, 3 x 3 convs) beside a full-frame
    spectral one (a 3 x 3 conv, then two 1 x 1 convs on the real-first
    packed spectrum), fused by a 1 x 1 conv."""

    def __init__(self, dim: int):
        super().__init__()
        d = dim
        self.spatial0 = Conv2d(d, d // 2, 3)
        self.spatial1 = Conv2d(d // 2, d // 2, 1)
        self.spatial2 = Conv2d(d // 2, d, 3)
        self.conv = Conv2d(d, d, 3)
        self.fft0 = Conv2d(2 * d, 2 * d, 1)
        self.fft1 = Conv2d(2 * d, 2 * d, 1)
        self.fuse = Conv2d(2 * d, d, 1)

    def forward(self, x):
        s = self.spatial2(_lrelu(self.spatial1(_lrelu(self.spatial0(x)))))
        y = _lrelu(self.conv(x))
        h, w = y.shape[1:3]
        f = torch.fft.rfft2(y.float(), dim=(1, 2), norm="backward")
        yf = torch.cat([f.real, f.imag], -1).to(x.dtype)
        yf = _lrelu(self.fft1(_lrelu(self.fft0(yf))))
        re, im = yf.float().chunk(2, dim=-1)
        fout = torch.fft.irfft2(torch.complex(re, im), s=(h, w), dim=(1, 2),
                                norm="backward").to(x.dtype)
        return self.fuse(torch.cat([fout, s], -1))


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


class _BatchStatsNorm2d(BatchNorm2d):
    """Batch norm of an NHWC tensor as flax's ``BatchNorm`` trains: in
    training mode it normalises on the batch's statistics over (B, H, W),
    in float32, the variance E[x^2] - E[x]^2 (biased, clipped at 0), and
    updates the running statistics with them: ``running = (1 - momentum)
    * running + momentum * batch`` (flax's momentum 0.9 is 0.1 here).
    ``nn.BatchNorm2d`` would update the running variance with the unbiased
    one.  In eval mode it runs on the running statistics."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        mean = xf.mean((0, 1, 2))
        var = (xf.square().mean((0, 1, 2)) - mean.square()).clamp_min(0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
            self.num_batches_tracked += 1
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * scale + self.bias).to(x.dtype)


class FourierUnit(nn.Module):
    """The Fourier SE gate: a per-channel constant image, the DC bin of the
    inverse transform of the gated pooled spectrum (closed form).
    ``train=True``: its batch norm normalises on batch statistics while
    the module is in training mode (``_BatchStatsNorm2d``), as the JAX
    block's ``train=True`` does."""

    def __init__(self, channels: int, train: bool = False):
        super().__init__()
        c = channels
        self.channels = c
        self.conv_layer = Conv2d(2 * c, 2 * c, 1, bias=False)
        self.bn = (_BatchStatsNorm2d if train else BatchNorm2d)(
            2 * c, eps=1e-5, momentum=0.1)
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


class MultiFreqAgg(nn.Module):
    """Selective-kernel aggregation of ``height`` band features: the
    pooled sum's SE gives one attention a band, softmaxed over the bands,
    and the bands are summed under it."""

    def __init__(self, in_channels: int, height: int = 3,
                 reduction: int = 8):
        super().__init__()
        d = max(in_channels // reduction, 4)
        self.height = height
        self.conv_du = Conv2d(in_channels, d, 1, bias=False)
        for i in range(height):
            self.add_module(f"fc{i}", Conv2d(d, in_channels, 1, bias=False))

    def forward(self, feats):
        stack = torch.stack(list(feats), 1)              # (B, K, H, W, C)
        z = _lrelu(self.conv_du(stack.sum(1).mean((1, 2), keepdim=True)))
        att = torch.stack([getattr(self, f"fc{i}")(z)
                           for i in range(self.height)], 1)
        return (stack * torch.softmax(att, dim=1)).sum(1)


class SpaFreqBlock(nn.Module):
    """Four rounds of a Fourier gate and a spatial attention, each round's
    two fused by ``SKFF`` and fed to the next; plus the input.  ``train``
    goes to the Fourier gates."""

    def __init__(self, dim: int, train: bool = False):
        super().__init__()
        for i in range(4):
            self.add_module(f"fu{i}", FourierUnit(dim, train))
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


# -- shift encoders ---------------------------------------------------------

_SHIFT_DIRS_16 = [
    (8, 8), (8, 4), (8, 0), (8, -4), (8, -8),
    (-8, 8), (-8, 4), (-8, 0), (-8, -4), (-8, -8),
    (4, 8), (4, -8), (0, 8), (0, -8), (-4, 8), (-4, -8),
]
_SHIFT_DIRS_8 = [
    (4, 4), (4, 0), (4, -4), (0, 4), (0, -4), (-4, 4), (-4, 0), (-4, -4),
]


def _shift2d(x, sy: int, sx: int):
    """Zero-fill shift of (B, H, W, C): out[y, x] = in[y - sy, x - sx]."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, max(sx, 0), max(-sx, 0), max(sy, 0), max(-sy, 0)))
    return xp[:, max(-sy, 0):max(-sy, 0) + h, max(-sx, 0):max(-sx, 0) + w]


def spatial_shift24(hw: torch.Tensor, number: int) -> torch.Tensor:
    """24-direction grouped spatial shift of (B, H, W, 8 number): 16 groups
    of n2 = (number - 1) // 2 channels shifted by the +-8 / +-4 pairs, then
    8 groups of n1 = number - 2 n2 by the +-4 pairs; channels past the
    groups are zeroed."""
    n2 = (number - 1) // 2
    n1 = number - 2 * n2
    parts = []
    c = 0
    for sy, sx in _SHIFT_DIRS_16:
        if n2:
            parts.append(_shift2d(hw[..., c:c + n2], sy, sx))
        c += n2
    for sy, sx in _SHIFT_DIRS_8:
        if n1:
            parts.append(_shift2d(hw[..., c:c + n1], sy, sx))
        c += n1
    tail = hw.shape[-1] - c
    if tail > 0:
        parts.append(torch.zeros_like(hw[..., :tail]))
    return torch.cat(parts, -1) if parts else hw


def channel_shift(x: torch.Tensor, number: int, div: int = 2,
                  reverse: bool = False) -> torch.Tensor:
    """Cross-frame channel roll and spatial shift of (B, H, W, C): the
    flattened (frame, channel) axis of the NCHW view rolls by C / div
    (-C / div with ``reverse``), so channels move into the next (previous)
    frame of the batch; the first (last) frame stays unrolled; the
    24-direction shift of the leading (trailing) 8 number channels is
    appended: (B, H, W, C + 8 number)."""
    b, h, w, c = x.shape
    roll = -(c // div) if reverse else c // div
    flat = x.permute(0, 3, 1, 2).reshape(b * c, h, w)
    rolled = torch.roll(flat, roll, 0).reshape(b, c, h, w).permute(0, 2, 3, 1)
    if reverse:
        y = torch.cat([rolled[:-1], x[-1:]], 0)
        hw = y[..., -8 * number:]
    else:
        y = torch.cat([x[:1], rolled[1:]], 0)
        hw = y[..., :8 * number]
    return torch.cat([y, spatial_shift24(hw, number)], -1)


class EncoderShiftBlock(nn.Module):
    """8 stages, the shift's direction alternating: ``channel_shift``, then
    ``CAB2`` (``cab2_i``) or, with ``use_fsas``, ``FSAS_freq``
    (``fsas{i}``) on the shifted channels, then ``CAB1`` (``cab1_i``)."""

    def __init__(self, n_feat: int, reduction: int = 4,
                 use_fsas: bool = False):
        super().__init__()
        self.number = n = n_feat // 2 // 8
        self.use_fsas = use_fsas
        for i in range(8):
            if use_fsas:
                self.add_module(f"fsas{i}", FSAS_freq(n_feat,
                                                      add_channel=8 * n))
            else:
                self.add_module(f"cab2_{i}", CAB2(
                    n_feat, add_channel=8 * n, kernel_size=5,
                    reduction=reduction))
            self.add_module(f"cab1_{i}", CAB1(n_feat, 5, reduction))

    def forward(self, x):
        for i in range(8):
            x = channel_shift(x, self.number, reverse=bool(i % 2))
            mix = getattr(self, f"fsas{i}" if self.use_fsas else f"cab2_{i}")
            x = getattr(self, f"cab1_{i}")(mix(x))
        return x


# -- U-Net parts ------------------------------------------------------------


class ResidualBlockNoBN(nn.Module):
    """conv - PReLU - conv (3 x 3, no bias), channel attention ``CA``
    (reduction 4), times ``res_scale``, plus the input."""

    def __init__(self, mid_channels: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv2d(mid_channels, mid_channels, 3, bias=False)
        self.relu = PReLU()
        self.conv2 = Conv2d(mid_channels, mid_channels, 3, bias=False)
        self.CA = CALayer(mid_channels, 4)

    def forward(self, x):
        out = self.CA(self.conv2(self.relu(self.conv1(x))))
        return x + out * self.res_scale


class ResidualBlocksWithInputConv(nn.Module):
    """An input conv (3 x 3, no bias) and PReLU, then ``num_blocks``
    ``ResidualBlockNoBN`` (``block{i}``)."""

    def __init__(self, in_channels: int, out_channels: int = 64,
                 num_blocks: int = 30):
        super().__init__()
        self.num_blocks = num_blocks
        self.input_conv = Conv2d(in_channels, out_channels, 3, bias=False)
        self.act = PReLU()
        for i in range(num_blocks):
            self.add_module(f"block{i}", ResidualBlockNoBN(out_channels))

    def forward(self, x):
        y = self.act(self.input_conv(x))
        for i in range(self.num_blocks):
            y = getattr(self, f"block{i}")(y)
        return y


class SAM(nn.Module):
    """Supervised attention: ``(x1 * sigmoid(conv3(img)) + x, img)``, with
    ``img = conv2(x) + x_img`` (3 channels) and ``x1 = conv1(x)``."""

    def __init__(self, n_feat: int, kernel_size: int = 3):
        super().__init__()
        self.conv1 = Conv2d(n_feat, n_feat, kernel_size, bias=False)
        self.conv2 = Conv2d(n_feat, 3, 3, bias=False)
        self.conv3 = Conv2d(3, n_feat, kernel_size, bias=False)

    def forward(self, x, x_img):
        img = self.conv2(x) + x_img
        return self.conv1(x) * torch.sigmoid(self.conv3(img)) + x, img


class DownSample(nn.Module):
    """A stride-2 3 x 3 conv (with bias, symmetric padding 1, not XLA's
    SAME) from ``in_channels`` to ``in_channels + s_factor``."""

    def __init__(self, in_channels: int, s_factor: int):
        super().__init__()
        self.down = Conv2d(in_channels, in_channels + s_factor, 3, stride=2)

    def forward(self, x):
        return self.down(x)


class UpSample(nn.Module):
    """2x bilinear upsample, then a 1 x 1 conv (no bias) from
    ``in_channels + s_factor`` to ``in_channels``."""

    def __init__(self, in_channels: int, s_factor: int):
        super().__init__()
        self.up = Conv2d(in_channels + s_factor, in_channels, 1, bias=False)

    def forward(self, x):
        return self.up(upsample2x_bilinear(x))


class SkipUpSample(UpSample):
    """``UpSample`` plus the skip."""

    def forward(self, x, skip):
        return super().forward(x) + skip


class _CABStack(nn.Module):
    """A module built of named CAB runs (``{prefix}_{i}``)."""

    def _cabs(self, prefix: str, count: int, n: int, kernel_size: int,
              reduction: int) -> None:
        for i in range(count):
            self.add_module(f"{prefix}_{i}", CAB(n, kernel_size, reduction))

    def _run(self, prefix: str, count: int, x):
        for i in range(count):
            x = getattr(self, f"{prefix}_{i}")(x)
        return x


class CABEncoder(_CABStack):
    """3 levels of 2 CABs, widening by n_feat // 2 at each stride-2
    ``DownSample``; returns the 3 levels' outputs."""

    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 4):
        super().__init__()
        n, s = n_feat, n_feat // 2
        self._cabs("level1", 2, n, kernel_size, reduction)
        self.down12 = DownSample(n, s)
        self._cabs("level2", 2, n + s, kernel_size, reduction)
        self.down23 = DownSample(n + s, s)
        self._cabs("level3", 2, n + 2 * s, kernel_size, reduction)

    def forward(self, x):
        enc1 = self._run("level1", 2, x)
        enc2 = self._run("level2", 2, self.down12(enc1))
        enc3 = self._run("level3", 2, self.down23(enc2))
        return [enc1, enc2, enc3]


class CABDecoder(_CABStack):
    """The decoder of ``CABEncoder``'s 3 levels: 2 CABs a level, each
    ``SkipUpSample`` adding the CAB-attended skip (``skip_attn2``,
    ``skip_attn1``); returns the 3 levels' outputs, finest first."""

    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 4):
        super().__init__()
        n, s = n_feat, n_feat // 2
        self._cabs("level3", 2, n + 2 * s, kernel_size, reduction)
        self.up32 = SkipUpSample(n + s, s)
        self.skip_attn2 = CAB(n + s, kernel_size, reduction)
        self._cabs("level2", 2, n + s, kernel_size, reduction)
        self.up21 = SkipUpSample(n, s)
        self.skip_attn1 = CAB(n, kernel_size, reduction)
        self._cabs("level1", 2, n, kernel_size, reduction)

    def forward(self, outs):
        enc1, enc2, enc3 = outs
        dec3 = self._run("level3", 2, enc3)
        dec2 = self._run("level2", 2, self.up32(dec3, self.skip_attn2(enc2)))
        dec1 = self._run("level1", 2, self.up21(dec2, self.skip_attn1(enc1)))
        return [dec1, dec2, dec3]


class TFRUNet(_CABStack):
    """A compact CAB U-Net (``scale_unetfeats`` 12): 1, 3 and 3 CABs down,
    3, 3 and 1 up, skips attended by a CAB; H and W multiples of 4."""

    def __init__(self, n_feat: int, kernel_size: int = 3, reduction: int = 4):
        super().__init__()
        n, s, k, r = n_feat, 12, kernel_size, reduction
        self._cabs("enc1", 1, n, k, r)
        self.down12 = DownSample(n, s)
        self._cabs("enc2", 3, n + s, k, r)
        self.down23 = DownSample(n + s, s)
        self._cabs("enc3", 3, n + 2 * s, k, r)
        self._cabs("dec3", 3, n + 2 * s, k, r)
        self.up32 = SkipUpSample(n + s, s)
        self.skip_attn2 = CAB(n + s, k, r)
        self._cabs("dec2", 3, n + s, k, r)
        self.up21 = SkipUpSample(n, s)
        self.skip_attn1 = CAB(n, k, r)
        self._cabs("dec1", 1, n, k, r)

    def forward(self, x):
        enc1 = self._run("enc1", 1, x)
        enc2 = self._run("enc2", 3, self.down12(enc1))
        enc3 = self._run("enc3", 3, self.down23(enc2))
        dec3 = self._run("dec3", 3, enc3)
        dec2 = self._run("dec2", 3, self.up32(dec3, self.skip_attn2(enc2)))
        return self._run("dec1", 1, self.up21(dec2, self.skip_attn1(enc1)))


class ShallowCell(nn.Module):
    """A 3 x 3 conv (no bias) from ``in_channels`` to ``n_feat``, then a
    CAB."""

    def __init__(self, in_channels: int, n_feat: int):
        super().__init__()
        self.conv = Conv2d(in_channels, n_feat, 3, bias=False)
        self.cab = CAB(n_feat, 3, 4)

    def forward(self, x):
        return self.cab(self.conv(x))


class Encoder2(nn.Module):
    """The shift encoder's entry: a conv from ``in_channels`` (the
    reference's 3 x 24), a CAB, the FSAS flavour of ``EncoderShiftBlock``,
    fused with a CAB-attended skip of the conv's output by ``conv_hr0``,
    then a CAB; H and W multiples of 8."""

    def __init__(self, in_channels: int, n_feat: int, kernel_size: int = 3,
                 reduction: int = 4):
        super().__init__()
        n, k, r = n_feat, kernel_size, reduction
        self.concat = Conv2d(in_channels, n, k, bias=False)
        self.encoder_level1 = CAB(n, k, r)
        self.decoder_level1 = EncoderShiftBlock(n, r, use_fsas=True)
        self.skip_conv = CAB(n, k, r)
        self.conv_hr0 = Conv2d(2 * n, n, k)
        self.out_conv = CAB(n, k, r)

    def forward(self, x):
        y = self.concat(x)
        dec1 = self.decoder_level1(self.encoder_level1(y))
        out = self.conv_hr0(torch.cat([dec1, self.skip_conv(y)], -1))
        return self.out_conv(out)
