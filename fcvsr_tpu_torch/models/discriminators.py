"""Discriminators of the GAN restorers (counterpart of
``fcvsr_tpu.models.discriminators``), NHWC in, the JAX package's parameter
names:

* ``ModifiedVGG``: SRGAN / ESRGAN's 128 x 128 discriminator (batch norm:
  running statistics in eval mode, as the JAX package applies it);
* ``UNetDiscriminatorWithSpectralNorm``: RealBasicVSR's U-Net, per-pixel
  logits;
* ``LightCNN`` (with ``MaxFeature``): DICGAN's discriminator and the
  feature net of ``light_cnn_feature_loss``.

Spectral norm is written out (``SNConv2d``), not
``torch.nn.utils.spectral_norm``, which steps its power iteration and
writes ``u`` back on every training forward.  As the JAX package's
``nn.SpectralNorm(update_stats=False)`` does, each forward takes one power
step from the stored ``u`` (flax's layout: (1, Cout) over the kernel
reshaped to (kh kw Cin, Cout), eps 1e-12) with ``u`` and ``v`` detached,
divides the kernel by sigma = v W u^T, and never writes ``u`` (or
``sigma``) back: the JAX GAN trainer never updates them, so neither does
the port's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from .blocks import Conv2d

__all__ = ["ModifiedVGG", "UNetDiscriminatorWithSpectralNorm", "SNConv2d",
           "MaxFeature", "LightCNN", "light_cnn_feature_loss"]


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ModifiedVGG(nn.Module):
    """(B, 128, 128, C) -> (B, 1) logits."""

    def __init__(self, in_channels: int = 3, mid_channels: int = 64):
        super().__init__()
        m = mid_channels
        self.conv0_0 = Conv2d(in_channels, m, 3)
        # conv{i}_0 (3x3) keeps the size, conv{i}_1 (4x4, stride 2) halves
        # it; each without bias, then batch norm
        self.layers = []
        cin = m
        for i, cout in enumerate((m, m * 2, m * 4, m * 8, m * 8)):
            for j, k in ((0, 3), (1, 4)):
                if i == 0 and j == 0:
                    continue
                name = f"conv{i}_{j}"
                self.add_module(name, Conv2d(cin, cout, k, 1 + j, bias=False,
                                             padding=1))
                self.add_module(f"{name}_bn", nn.BatchNorm2d(cout,
                                                             momentum=0.01))
                self.layers.append(name)
                cin = cout
        self.linear1 = nn.Linear(m * 8 * 4 * 4, 100)
        self.linear2 = nn.Linear(100, 1)

    def forward(self, x):
        y = _lrelu(self.conv0_0(x))
        for name in self.layers:
            y = getattr(self, name)(y).permute(0, 3, 1, 2)
            y = _lrelu(getattr(self, f"{name}_bn")(y).permute(0, 2, 3, 1))
        y = _lrelu(self.linear1(y.reshape(y.shape[0], -1)))
        return self.linear2(y)


def _l2_normalize(x, eps=1e-12):
    return x * torch.rsqrt((x * x).sum() + eps)


class SNConv2d(Conv2d):
    """A conv whose kernel is divided by its spectral norm, estimated by
    one power step from the stored ``u`` (a buffer, never written);
    ``sigma`` is the JAX package's stored estimate, kept for its
    checkpoints and unused."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding=None, bias: bool = False):
        super().__init__(cin, cout, k, stride, bias=bias, padding=padding)
        self.register_buffer("u", torch.zeros(1, cout))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self):
        cout = self.weight.shape[0]
        # flax's (kh kw Cin, Cout) matrix, rows in HWI order
        w = self.weight.permute(2, 3, 1, 0).reshape(-1, cout)
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.t())
            u = _l2_normalize(v @ w)
        sigma = (v @ w @ u.t())[0, 0]
        return self.weight / torch.where(sigma != 0, sigma,
                                         torch.ones_like(sigma))

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.normalized_weight(),
                     self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_seeded(self, generator: torch.Generator) -> None:
        self.u.copy_(torch.randn(self.u.shape, generator=generator))
        self.sigma.fill_(1.0)


class UNetDiscriminatorWithSpectralNorm(nn.Module):
    """(B, H, W, C) -> (B, H, W, 1) per-pixel logits; H and W multiples of
    8."""

    def __init__(self, in_channels: int = 3, mid_channels: int = 64,
                 skip_connection: bool = True):
        super().__init__()
        m = mid_channels
        self.skip_connection = skip_connection
        self.conv_0 = Conv2d(in_channels, m, 3)
        self.conv_1 = SNConv2d(m, m * 2, 4, 2, padding=1)
        self.conv_2 = SNConv2d(m * 2, m * 4, 4, 2, padding=1)
        self.conv_3 = SNConv2d(m * 4, m * 8, 4, 2, padding=1)
        self.conv_4 = SNConv2d(m * 8, m * 4, 3)
        self.conv_5 = SNConv2d(m * 4, m * 2, 3)
        self.conv_6 = SNConv2d(m * 2, m, 3)
        self.conv_7 = SNConv2d(m, m, 3)
        self.conv_8 = SNConv2d(m, m, 3)
        self.conv_9 = Conv2d(m, 1, 3)

    def forward(self, img):
        x0 = _lrelu(self.conv_0(img))
        x1 = _lrelu(self.conv_1(x0))
        x2 = _lrelu(self.conv_2(x1))
        x3 = _lrelu(self.conv_3(x2))

        def up(y):
            return resize_bilinear(y, y.shape[1] * 2, y.shape[2] * 2)

        x4 = _lrelu(self.conv_4(up(x3)))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = _lrelu(self.conv_5(up(x4)))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = _lrelu(self.conv_6(up(x5)))
        if self.skip_connection:
            x6 = x6 + x0
        out = _lrelu(self.conv_8(_lrelu(self.conv_7(x6))))
        return self.conv_9(out)


class MaxFeature(nn.Module):
    """Max-feature-map: a conv (or linear) to twice the channels, the
    elementwise max of the two halves (``filter``)."""

    def __init__(self, cin: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, filter_type: str = "conv2d"):
        super().__init__()
        self.out_channels = out_channels
        self.filter = Conv2d(cin, 2 * out_channels, kernel_size, stride) \
            if filter_type == "conv2d" else nn.Linear(cin, 2 * out_channels)

    def forward(self, x):
        a, b = torch.split(self.filter(x), self.out_channels, -1)
        return torch.maximum(a, b)


def _pool(y):
    """2x2 max pool, ceil mode (a ragged edge pools what it has, as the
    JAX package's -inf padding does), NHWC."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2,
                        ceil_mode=True).permute(0, 2, 3, 1)


class LightCNN(nn.Module):
    """(B, 128, 128, C) -> (B, 1) logits; ``features_only`` stops after the
    conv trunk (B, 8, 8, 128)."""

    _TRUNK = (("mf0", 48, 5), "pool", ("mf1", 48, 1), ("mf2", 96, 3), "pool",
              ("mf3", 96, 1), ("mf4", 192, 3), "pool", ("mf5", 192, 1),
              ("mf6", 128, 3), ("mf7", 128, 1), ("mf8", 128, 3), "pool")

    def __init__(self, in_channels: int = 3):
        super().__init__()
        cin = in_channels
        for layer in self._TRUNK:
            if layer != "pool":
                name, cout, k = layer
                self.add_module(name, MaxFeature(cin, cout, k))
                cin = cout
        self.fc0 = MaxFeature(cin * 8 * 8, 256, filter_type="linear")
        self.fc1 = nn.Linear(256, 1)

    def forward(self, x, features_only: bool = False):
        y = x
        for layer in self._TRUNK:
            y = _pool(y) if layer == "pool" else getattr(self, layer[0])(y)
        if features_only:
            return y
        y = _lrelu(self.fc0(y.reshape(y.shape[0], -1)))
        return self.fc1(y)


def light_cnn_feature_loss(model: LightCNN, pred, gt,
                           loss_weight: float = 1.0,
                           criterion: str = "l1"):
    """DICGAN's feature loss: the distance of LightCNN's trunk features of
    ``pred`` from those of ``gt`` (detached), NHWC images."""
    pf = model(pred, features_only=True)
    gf = model(gt, features_only=True).detach()
    d = pf - gf
    loss = d.abs().mean() if criterion == "l1" else (d * d).mean()
    return loss * loss_weight
