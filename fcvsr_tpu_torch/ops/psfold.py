"""Polyphase (sub-pixel) folding of a conv after a pixel shuffle (the
port's copy of ``fcvsr_tpu.ops.psfold``'s ``fold_ps_conv`` and
``fold_ps_bias``).

``conv(pixel_shuffle(x, r), k) == pixel_shuffle(conv(x, fold_ps_conv(k,
r)), r)`` for SAME, stride-1 convs with zero padding: each output phase
(p, q) of the upsampled grid reads input taps whose positions fold back to
low-resolution offsets ``floor((p+a)/r)`` and channel phases ``(p+a) mod
r``.  FCVSR's folded tail (``FCVSRNet(tail_impl='folded')``) folds every
conv below the first shuffle, so the tail runs at (H, W) with wide
channels.  The folded kernels are a pure rearrangement of the live
weights (differentiable, checkpoint-compatible); entries a phase does not
use stay zero.

Channel convention of ``models.blocks.pixel_shuffle`` (torch
PixelShuffle): channel ``c*r*r + i*r + j`` shuffles to offset ``(i, j)``.
"""

from __future__ import annotations

import torch

__all__ = ["fold_ps_conv", "fold_ps_bias"]


def fold_ps_conv(kernel: torch.Tensor, r: int) -> torch.Tensor:
    """Fold a SAME, stride-1 conv over a preceding r-x pixel shuffle.

    kernel: HWIO ``(k, k, Cin, Cout)`` for the conv applied on the shuffled
    (rH, rW, Cin) grid, k odd.  Returns ``(S, S, Cin*r*r, Cout*r*r)`` HWIO
    with input channels read as ``c*r*r + i*r + j`` (the pre-shuffle
    layout) and output channels emitted in the same convention, so folds
    nest.  S covers every phase's taps: 1 for a 1x1 kernel, 3 for a 3x3
    at r = 2."""
    k, k2, cin, cout = kernel.shape
    if k != k2 or k % 2 == 0:
        raise ValueError(f"square odd kernels only, got {k}x{k2}")
    m = (k - 1) // 2
    s_min = (0 - m) // r
    s_max = (r - 1 + m) // r
    size = s_max - s_min + 1
    o = -s_min
    rr = r * r
    folded = kernel.new_zeros((size, size, cin * rr, cout * rr))
    for a in range(k):
        for b in range(k):
            for p in range(r):
                for q in range(r):
                    s, i = divmod(p + a - m, r)
                    t, j = divmod(q + b - m, r)
                    folded[s + o, t + o, i * r + j::rr, p * r + q::rr] = \
                        kernel[a, b]
    return folded


def fold_ps_bias(bias: torch.Tensor, r: int) -> torch.Tensor:
    """Bias of the folded conv: per output channel, the same for every
    phase (channel ``d*r*r + p*r + q``)."""
    return bias.repeat_interleave(r * r)
