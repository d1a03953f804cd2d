"""LIIF, the local implicit image function (counterpart of
``fcvsr_tpu.models.liif``; reference sr_backbones/liif_net.py).

Continuous-resolution SR: an encoder trunk (EDSR's or RDN's, without its
upsampler) makes a feature map; an MLP (``imnet``) is queried at any
continuous coordinates, each query ensembled over the 4 latent codes
around it (weighted by the opposite areas).  As the JAX package does, the
nearest sampling rounds ``p + 0.5`` down and gathers by flat index (not
``grid_sample``'s half to even), the 3x3 feature unfold is channel-major
and tap-minor, and the ensemble's shift pairs the y offset with ``1 / fh``
and the x offset with ``1 / fw`` as written there.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .sisr import _EDSRTrunk, _RDNTrunk

__all__ = ["LIIFEDSR", "LIIFRDN", "MLPRefiner", "make_coord"]


def make_coord(shape, ranges=None, flatten: bool = True,
               device=None) -> torch.Tensor:
    """Pixel-centre coordinates in [-1, 1] (mmedit pipelines/utils.py), (y,
    x) order: (H*W, 2), or (H, W, 2) unflattened."""
    seqs = []
    for i, n in enumerate(shape):
        lo, hi = (-1.0, 1.0) if ranges is None else ranges[i]
        r = (hi - lo) / (2 * n)
        seqs.append(lo + r + (2 * r) * torch.arange(
            n, dtype=torch.float32, device=device))
    gy, gx = torch.meshgrid(seqs[0], seqs[1], indexing="ij")
    coord = torch.stack([gy, gx], dim=-1)
    return coord.reshape(-1, 2) if flatten else coord


class MLPRefiner(nn.Module):
    """The LIIF imnet: a ReLU MLP (``fc{i}``, then ``fc_out``)."""

    def __init__(self, in_dim: int, out_dim: int = 3,
                 hidden_list: Sequence[int] = (256, 256, 256, 256)):
        super().__init__()
        dims = [in_dim] + list(hidden_list)
        for i in range(len(hidden_list)):
            self.add_module(f"fc{i}", nn.Linear(dims[i], dims[i + 1]))
        self.num_hidden = len(hidden_list)
        self.fc_out = nn.Linear(dims[-1], out_dim)

    def forward(self, x):
        for i in range(self.num_hidden):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return self.fc_out(x)


def _nearest_sample(feat: torch.Tensor, coord: torch.Tensor) -> torch.Tensor:
    """The feature (B, H, W, C) at the pixel nearest each (y, x) coordinate
    (B, Q, 2) in [-1, 1], half-pixel centres: ``floor(p + 0.5)``, clamped
    to the frame.  Returns (B, Q, C)."""
    b, h, w, c = feat.shape
    py = (coord[..., 0] + 1) * (h / 2) - 0.5
    px = (coord[..., 1] + 1) * (w / 2) - 0.5
    iy = torch.floor(py + 0.5).long().clamp(0, h - 1)
    ix = torch.floor(px + 0.5).long().clamp(0, w - 1)
    idx = (iy * w + ix).unsqueeze(-1).expand(-1, -1, c)
    return torch.gather(feat.reshape(b, h * w, c), 1, idx)


def _unfold3x3(feat: torch.Tensor) -> torch.Tensor:
    """Each pixel's zero-padded 3x3 neighbourhood along channels, (B, H, W,
    C * 9), channel c * 9 + tap (``F.unfold(feature, 3, padding=1)``'s
    order, so imported checkpoints line up)."""
    b, h, w, c = feat.shape
    xp = F.pad(feat, (0, 0, 1, 1, 1, 1))
    taps = torch.stack([xp[:, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)], dim=-1)
    return taps.reshape(b, h, w, c * 9)


class _LIIFQuery(nn.Module):
    """The query logic (liif_net.py:12-200) over the trunk's features;
    subclasses give ``features``."""

    def _init_query(self, mid_channels: int, out_dim: int,
                    local_ensemble: bool, feat_unfold: bool,
                    cell_decode: bool, imnet_hidden: Sequence[int]) -> None:
        self.local_ensemble = local_ensemble
        self.feat_unfold = feat_unfold
        self.cell_decode = cell_decode
        in_dim = mid_channels * (9 if feat_unfold else 1) + 2 \
            + (2 if cell_decode else 0)
        self.imnet = MLPRefiner(in_dim, out_dim, tuple(imnet_hidden))

    def forward(self, x, coord, cell):
        """x: (B, 3, h, w); coord, cell: (B, Q, 2) -> (B, Q, out_dim)."""
        feature = self.features(x.permute(0, 2, 3, 1))
        b, fh, fw, _ = feature.shape
        if self.feat_unfold:
            feature = _unfold3x3(feature)
        if self.local_ensemble:
            vx_lst, vy_lst, eps = [-1, 1], [-1, 1], 1e-6
        else:
            vx_lst, vy_lst, eps = [0], [0], 0.0
        rx, ry = 1.0 / fh, 1.0 / fw
        feat_coord = make_coord((fh, fw), flatten=False,
                                device=x.device).to(coord.dtype)
        feat_coord = feat_coord.expand(b, fh, fw, 2)
        scale = coord.new_tensor([fh, fw])
        preds, areas = [], []
        for vx in vx_lst:
            for vy in vy_lst:
                shift = coord.new_tensor([vx * rx + eps, vy * ry + eps])
                coord_ = (coord + shift).clamp(-1 + 1e-6, 1 - 1e-6)
                q_feat = _nearest_sample(feature, coord_)
                q_coord = _nearest_sample(feat_coord, coord_)
                rel = (coord - q_coord) * scale
                inp = [q_feat, rel]
                if self.cell_decode:
                    inp.append(cell * scale)
                preds.append(self.imnet(torch.cat(inp, -1)))
                areas.append((rel[..., 0] * rel[..., 1]).abs() + 1e-9)
        total = sum(areas)
        if self.local_ensemble:
            areas = areas[::-1]
        return sum(p * (a / total).unsqueeze(-1)
                   for p, a in zip(preds, areas))


class LIIFEDSR(_EDSRTrunk, _LIIFQuery):
    """LIIF on EDSR's trunk (liif_net.py:205-260): 64 channels, 16 blocks,
    imnet (256,) x 4; local ensemble, feature unfold and cell decode on."""

    def __init__(self, mid_channels: int = 64, out_dim: int = 3,
                 local_ensemble: bool = True, feat_unfold: bool = True,
                 cell_decode: bool = True,
                 imnet_hidden: Sequence[int] = (256, 256, 256, 256),
                 num_blocks: int = 16, res_scale: float = 1.0):
        super().__init__(3, mid_channels, num_blocks, res_scale)
        self._init_query(mid_channels, out_dim, local_ensemble, feat_unfold,
                         cell_decode, imnet_hidden)


class LIIFRDN(_RDNTrunk, _LIIFQuery):
    """LIIF on RDN's trunk (liif_net.py:263-322): 64 channels, 16 blocks
    of 8 layers, growth 64; the same imnet and switches."""

    def __init__(self, mid_channels: int = 64, out_dim: int = 3,
                 local_ensemble: bool = True, feat_unfold: bool = True,
                 cell_decode: bool = True,
                 imnet_hidden: Sequence[int] = (256, 256, 256, 256),
                 num_blocks: int = 16, num_layers: int = 8,
                 channel_growth: int = 64):
        super().__init__(3, mid_channels, num_blocks, num_layers,
                         channel_growth)
        self._init_query(mid_channels, out_dim, local_ensemble, feat_unfold,
                         cell_decode, imnet_hidden)
