"""RAFT optical flow (counterpart of ``fcvsr_tpu.models.raft``; the
reference's CVSR_train/arch/raft/).

The full-size RAFT at the reference's fixed hyper-parameters: hidden and
context 128, a 4-level all-pairs correlation pyramid of radius 4,
separable-conv GRU updates and convex upsampling.  ``raft_flow`` is the
reference's ``RAFT_flow`` wrapper, resizing to multiples of 8.  Images are
channels-last (B, H, W, 3), as the JAX package takes them.

As in the JAX package: the feature encoder's instance norm is flax's
``GroupNorm(group_size=1)`` (affine, eps 1e-6, the variance as E[x^2] -
E[x]^2), the context encoder's batch norm runs on running statistics (eps
1e-5), the correlation volume is scaled by 1/sqrt(C) and pooled 2 x 2
(floored) into its levels, the lookups sample bilinearly with zeros
outside, and the (2r+1)^2 offsets come in ``meshgrid(dx, dy)`` order (x
fastest), the channel order the motion encoder's ``convc1`` sees.  The
feature encoder takes both images as one batch.  The all-pairs
correlation is a batched matrix product; no kernel of the port lies on
this path.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from ..ops.warp import grid_sample_bilinear
from .blocks import BatchNorm2d, Conv2d

__all__ = ["RAFT", "raft_flow", "InstanceNorm"]


class InstanceNorm(nn.Module):
    """flax's ``GroupNorm(num_groups=None, group_size=1)`` on NHWC: each
    channel of each sample over H and W, ``weight`` and ``bias`` per
    channel, the variance E[x^2] - E[x]^2 clipped at 0, as flax computes
    it."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean((1, 2), keepdim=True)
        var = (x.square().mean((1, 2), keepdim=True) - mean.square()).clamp(
            min=0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def _norm(kind: str, channels: int) -> nn.Module:
    if kind == "instance":
        return InstanceNorm(channels)
    if kind == "batch":
        return BatchNorm2d(channels, eps=1e-5)
    return nn.Identity()


class _ResUnit(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 norm: str = "instance"):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride=stride)
        self.norm1 = _norm(norm, planes)
        self.conv2 = Conv2d(planes, planes, 3)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = Conv2d(cin, planes, 1, stride=stride)
            self.norm3 = _norm(norm, planes)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return torch.relu(x + y)


class _BasicEncoder(nn.Module):
    """(B, H, W, 3) -> (B, H/8, W/8, output_dim)."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2)
        self.norm1 = _norm(norm, 64)
        cin = 64
        for i, (planes, stride) in enumerate([(64, 1), (64, 1), (96, 2),
                                              (96, 1), (128, 2), (128, 1)]):
            self.add_module(f"res{i}", _ResUnit(cin, planes, stride, norm))
            cin = planes
        self.conv2 = Conv2d(128, output_dim, 1)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        for i in range(6):
            y = getattr(self, f"res{i}")(y)
        return self.conv2(y)


def _corr_pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int = 4):
    """All-pairs correlation pyramid: f (B, H, W, C) -> ``levels`` volumes
    (B*H*W, hl, wl, 1)."""
    b, h, w, c = f1.shape
    corr = torch.matmul(f1.reshape(b, h * w, c),
                        f2.reshape(b, h * w, c).transpose(1, 2))
    corr = (corr / math.sqrt(c)).reshape(b * h * w, h, w, 1)
    pyramid = [corr]
    for _ in range(levels - 1):
        # 2 x 2 average pooling, floored; a level may come out empty (a
        # 1/8 size under 8 at the coarsest), and its lookups then read 0
        n, hl, wl, _ = corr.shape
        corr = corr[:, :hl // 2 * 2, :wl // 2 * 2].reshape(
            n, hl // 2, 2, wl // 2, 2, 1).mean((2, 4))
        pyramid.append(corr)
    return pyramid


def _offsets(radius: int, device) -> torch.Tensor:
    """The (2r+1)^2 lookup offsets (dx, dy), dx fastest (JAX's
    ``meshgrid(dx, dy)`` order)."""
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx, dy], -1).reshape(-1, 2)


def _corr_lookup(pyramid, coords: torch.Tensor, radius: int = 4):
    """coords (B, H, W, 2): positions at 1/8 resolution -> (B, H, W,
    levels * (2r+1)^2)."""
    b, h, w, _ = coords.shape
    n = 2 * radius + 1
    delta = _offsets(radius, coords.device)
    outs = []
    for lvl, corr in enumerate(pyramid):
        pts = coords.reshape(b * h * w, 1, 2) / (2 ** lvl) + delta[None]
        sampled = grid_sample_bilinear(corr, pts[..., 0], pts[..., 1])
        outs.append(sampled.reshape(b, h, w, n * n))
    return torch.cat(outs, -1)


class _MotionEncoder(nn.Module):
    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 256, 1)
        self.convc2 = Conv2d(256, 192, 3)
        self.convf1 = Conv2d(2, 128, 7)
        self.convf2 = Conv2d(128, 64, 3)
        self.conv = Conv2d(192 + 64, 126, 3)

    def forward(self, flow, corr):
        c = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        f = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([c, f], -1)))
        return torch.cat([out, flow], -1)


class _SepConvGRU(nn.Module):
    """Two GRU updates, over 1 x 5 then 5 x 1 convs."""

    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden + input_dim
        for tag, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
            for gate in "zrq":
                self.add_module(f"conv{gate}{tag}", Conv2d(
                    cin, hidden, (kh, kw), padding=(kh // 2, kw // 2)))

    def _gru(self, h, x, tag: str):
        hx = torch.cat([h, x], -1)
        z = torch.sigmoid(getattr(self, f"convz{tag}")(hx))
        r = torch.sigmoid(getattr(self, f"convr{tag}")(hx))
        q = torch.tanh(getattr(self, f"convq{tag}")(
            torch.cat([r * h, x], -1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        return self._gru(self._gru(h, x, "1"), x, "2")


class _UpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden: int = 128):
        super().__init__()
        self.encoder = _MotionEncoder(corr_planes)
        self.gru = _SepConvGRU(hidden, 128 + hidden)
        self.flow_head1 = Conv2d(hidden, 256, 3)
        self.flow_head2 = Conv2d(256, 2, 3)
        self.mask1 = Conv2d(hidden, 256, 3)
        self.mask2 = Conv2d(256, 64 * 9, 1)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], -1))
        dflow = self.flow_head2(torch.relu(self.flow_head1(net)))
        mask = self.mask2(torch.relu(self.mask1(net)))
        return net, mask * 0.25, dflow


def _convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """flow (B, h8, w8, 2), mask (B, h8, w8, 9 * 64) -> (B, 8 h8, 8 w8, 2):
    each 8 x 8 cell a softmax-weighted mix of the 3 x 3 neighbours' flow
    x 8; the mask's channel tap * 64 + (dy * 8 + dx)."""
    b, h8, w8, _ = flow.shape
    m = torch.softmax(mask.reshape(b, h8, w8, 9, 64), 3)
    fp = F.pad(8 * flow, (0, 0, 1, 1, 1, 1))
    taps = torch.stack([fp[:, dy:dy + h8, dx:dx + w8] for dy in range(3)
                        for dx in range(3)], 3)            # (B, h8, w8, 9, 2)
    up = torch.einsum("bhwkc,bhwkm->bhwmc", taps, m)       # (B, h8, w8, 64, 2)
    up = up.reshape(b, h8, w8, 8, 8, 2).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(b, 8 * h8, 8 * w8, 2)


class RAFT(nn.Module):
    """image1, image2: (B, H, W, 3) in [0, 255], H and W multiples of 8 ->
    the flow from image1 to image2 (B, H, W, 2) after ``iters`` updates."""

    def __init__(self, iters: int = 12, corr_levels: int = 4,
                 corr_radius: int = 4):
        super().__init__()
        self.iters = iters
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.fnet = _BasicEncoder(256, "instance")
        self.cnet = _BasicEncoder(256, "batch")
        self.update_block = _UpdateBlock(
            corr_levels * (2 * corr_radius + 1) ** 2)

    def forward(self, image1, image2):
        b, h, w, _ = image1.shape
        if h % 8 or w % 8:
            raise ValueError(f"RAFT takes H and W multiples of 8, not {h} x "
                             f"{w}; raft_flow resizes")
        image1 = image1 / 127.5 - 1.0
        image2 = image2 / 127.5 - 1.0
        f1, f2 = self.fnet(torch.cat([image1, image2])).chunk(2)
        pyramid = _corr_pyramid(f1, f2, self.corr_levels)

        cmap = self.cnet(image1)
        net = torch.tanh(cmap[..., :128])
        inp = torch.relu(cmap[..., 128:])

        h8, w8 = h // 8, w // 8
        gy, gx = torch.meshgrid(
            torch.arange(h8, dtype=image1.dtype, device=image1.device),
            torch.arange(w8, dtype=image1.dtype, device=image1.device),
            indexing="ij")
        coords0 = torch.stack([gx, gy], -1)[None].expand(b, h8, w8, 2)
        coords1 = coords0
        mask = None
        for _ in range(self.iters):
            corr = _corr_lookup(pyramid, coords1, self.corr_radius)
            net, mask, dflow = self.update_block(net, inp, corr,
                                                 coords1 - coords0)
            coords1 = coords1 + dflow
        return _convex_upsample(coords1 - coords0, mask)


def raft_flow(model: RAFT, ref: torch.Tensor,
              supp: torch.Tensor) -> torch.Tensor:
    """The reference's ``RAFT_flow``: ref, supp (B, H, W, 3) in [0, 1], any
    H and W -> the flow (B, H, W, 2) in pixels of the input.  The images
    are resized (half-pixel bilinear, not padded) to the next multiples of
    8, and the flow resized back and rescaled by (W / W8, H / H8).  It runs
    where the model and the tensors are, under the caller's grad mode."""
    h, w = ref.shape[1:3]
    h8, w8 = -(-h // 8) * 8, -(-w // 8) * 8
    flow = model(resize_bilinear(ref * 255.0, h8, w8),
                 resize_bilinear(supp * 255.0, h8, w8))
    flow = resize_bilinear(flow, h, w)
    return flow * torch.tensor([w / w8, h / h8], dtype=flow.dtype,
                               device=flow.device)
