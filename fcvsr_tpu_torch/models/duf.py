"""DUF's dynamic upsampling filter (counterpart of
``fcvsr_tpu.models.duf``; reference sr_backbones/duf.py:1-64).

The reference expands the input with an identity ``im2col`` conv and
multiplies it by per-pixel generated filters; here the expansion is a
stack of zero-padded shifted copies and the product one ``einsum``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dynamic_upsampling_filter"]


def _shifted_taps(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C, kh*kw): tap dy*kw + dx reads x[h + dy -
    kh//2, w + dx - kw//2], zero outside the frame."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    return torch.stack([xp[:, dy:dy + h, dx:dx + w]
                        for dy in range(kh) for dx in range(kw)], dim=-1)


def dynamic_upsampling_filter(x: torch.Tensor, filters: torch.Tensor,
                              filter_size: tuple = (5, 5)) -> torch.Tensor:
    """Per-pixel dynamic upsampling filters, the same for every channel.

    x: (B, H, W, C) channels-last; filters: (B, H, W, kh*kw, up^2).
    Returns (B, H, W, C * up^2), channel c * up^2 + u (the reference's
    ``view(n, 3 * up2, h, w)``)."""
    kh, kw = filter_size
    if filters.shape[3] != kh * kw:
        raise ValueError(f"filters dim 3 ({filters.shape[3]}) != "
                         f"prod(filter_size) {kh * kw}")
    out = torch.einsum("bhwck,bhwku->bhwcu", _shifted_taps(x, kh, kw),
                       filters)
    b, h, w, c, u2 = out.shape
    return out.reshape(b, h, w, c * u2)
