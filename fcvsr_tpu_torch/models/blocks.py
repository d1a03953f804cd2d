"""Building blocks (counterpart of ``fcvsr_tpu.models.blocks``).

Modules take and return channels-last (B, H, W, C) tensors; convs run as
``F.conv2d`` on the NCHW view (a channels-last layout, no copy).  Parameter
names follow the reference checkpoints (``conv_du.0``, ``body.3.gcnet...``).

``compute_dtype`` (``Conv2d``, ``CALayer``, ``ConvBlk``, ``DivEnh``), the
JAX blocks' ``dtype``: None computes in the input's type; ``torch.bfloat16``
casts each conv's input, weight and bias to bf16 and stores its output in
bf16 (the serving flags ``head_dtype``, ``mffr_dtype`` and ``tail_dtype``).
Parameters stay float32, so the ``state_dict`` does not change.
:func:`set_compute_dtype` switches it on every conv of a module tree.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .scnet_rows import scnet_apply

__all__ = ["Conv2d", "PReLU", "CALayer", "ConvBlk", "ContextBlock", "RCB",
           "BlockRCB", "SCGroup", "SCNet", "DivEnh", "pixel_shuffle",
           "set_compute_dtype"]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with symmetric ``k // 2`` padding on NHWC tensors, in
    ``compute_dtype`` (None: the input's type)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 bias: bool = True, compute_dtype=None):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2,
                         bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), bias,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


def set_compute_dtype(module: nn.Module, dtype) -> None:
    """Set ``compute_dtype`` on every :class:`Conv2d` under ``module``."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = dtype


class PReLU(nn.PReLU):
    """Parametric ReLU with one shared slope, in its input's type;
    elementwise, so any layout."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


class CALayer(nn.Module):
    """Squeeze-and-excite channel attention; the spatial mean sums in
    float32."""

    def __init__(self, channel: int, reduction: int = 16, compute_dtype=None):
        super().__init__()
        self.conv_du = nn.Sequential(
            Conv2d(channel, channel // reduction, 1, bias=False,
                   compute_dtype=compute_dtype), nn.ReLU(),
            Conv2d(channel // reduction, channel, 1, bias=False,
                   compute_dtype=compute_dtype),
            nn.Sigmoid())

    def forward(self, x):
        y = x.float().mean((1, 2), keepdim=True).to(x.dtype)
        return x * self.conv_du(y)


class ConvBlk(nn.Module):
    """conv - PReLU - conv, plus (not around) channel attention; kernel size
    2 * index + 1."""

    def __init__(self, dim: int, index: int, compute_dtype=None):
        super().__init__()
        k = 2 * index + 1
        self.conv1 = Conv2d(dim, dim, k, bias=False,
                            compute_dtype=compute_dtype)
        self.conv2 = Conv2d(dim, dim, k, bias=False,
                            compute_dtype=compute_dtype)
        self.relu = PReLU()
        self.CA = CALayer(dim, 1, compute_dtype)

    def forward(self, x):
        out = self.conv2(self.relu(self.conv1(x)))
        return self.CA(out) + out


class ContextBlock(nn.Module):
    """Global-context block: spatial-softmax pooling, channel MLP, add."""

    def __init__(self, c: int):
        super().__init__()
        self.conv_mask = Conv2d(c, 1, 1, bias=False)
        self.channel_add_conv = nn.Sequential(
            Conv2d(c, c, 1, bias=False), nn.LeakyReLU(0.2),
            Conv2d(c, c, 1, bias=False))

    def forward(self, x):
        b, h, w, c = x.shape
        mask = torch.softmax(self.conv_mask(x).reshape(b, h * w), dim=1)
        ctx = torch.einsum("bpc,bp->bc", x.reshape(b, h * w, c), mask)
        return x + self.channel_add_conv(ctx.reshape(b, 1, 1, c))


class RCB(nn.Module):
    """Residual context block: parameters only, run by ``scnet_rows``."""

    def __init__(self, c: int):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(c, c, 3, bias=False), nn.LeakyReLU(0.2),
            Conv2d(c, c, 3, bias=False))
        self.gcnet = ContextBlock(c)


class BlockRCB(nn.Module):
    """Cross-scale residual block over an [L1, L2, L3] pyramid: parameters
    only, run by ``scnet_rows``."""

    def __init__(self, nf: int, width_multiplier: int = 2):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(nf, nf * width_multiplier, 3), nn.LeakyReLU(0.1),
            Conv2d(nf * width_multiplier, nf, 3), RCB(nf))
        self.down = nn.Sequential(Conv2d(nf, nf, 1))
        self.up = nn.Sequential(Conv2d(nf, nf, 1))


class SCGroup(nn.Module):
    """Three BlockRCBs and one conv shared across scales, with a residual:
    parameters only, run by ``scnet_rows``."""

    def __init__(self, nf: int, back_rbs: int = 3):
        super().__init__()
        self.body = nn.Sequential(*[BlockRCB(nf) for _ in range(back_rbs)])
        self.conv = Conv2d(nf, nf, 3)


class SCNet(nn.Module):
    """Stack of SCGroups with an outer residual, over NHWC [L1, L2, L3].
    Its 3x3 convs run on the CUDA conv kernels (their plain versions on the
    CPU): see ``models.scnet_rows``, which also says what the serving
    options ``fuse`` ('pair' or 'quad') and ``dtype`` ('f32' or 'bf16')
    do.  Neither changes the parameters."""

    def __init__(self, nf: int, num_groups: int = 10, fuse: str = "pair",
                 dtype: str = "f32"):
        super().__init__()
        self.fuse, self.dtype = fuse, dtype
        self.body = nn.Sequential(*[SCGroup(nf) for _ in range(num_groups)])

    def forward(self, xs):
        return scnet_apply(self, xs, self.fuse, self.dtype)


class DivEnh(nn.Module):
    """Per-band detail enhancement, in its input's type (a and b cast to
    it).  ``Conv`` is defined but never called by the reference forward; it
    is kept so reference checkpoints load."""

    def __init__(self, c: int, compute_dtype=None):
        super().__init__()
        self.Conv = Conv2d(c, c, 3)
        self.a = nn.Parameter(torch.zeros(c, 1, 1))
        self.b = nn.Parameter(torch.ones(c, 1, 1))
        self.ca = CALayer(c, compute_dtype=compute_dtype)

    def forward(self, x, x_before_sum=None, ex_before_sum=None):
        a, b = self.a.reshape(-1).to(x.dtype), self.b.reshape(-1).to(x.dtype)
        if x_before_sum is None:
            out = x - x.mean((1, 2), keepdim=True)
            return self.ca(0.2 * a * out * x + b * x)
        out = x - x_before_sum + 0.2 * ex_before_sum
        out1 = self.ca(0.2 * a * out * x + b * x)
        out2 = self.ca(0.2 * a * ex_before_sum * x + b * x)
        return out1 + out2


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Depth-to-space in torch PixelShuffle channel order, NHWC:
    (B, H, W, C*r*r), channel c*r*r + i*r + j -> (B, H*r, W*r, C)."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)
