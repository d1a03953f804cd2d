"""Polyphase (sub-pixel) folding of a conv after a pixel shuffle (the
port's copy of ``fcvsr_tpu.ops.psfold``).

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

The phase-blocked tail (``FCVSRNet(tail_impl='folded_pb')``) applies an
r = 2 fold of a 3x3 conv as four 2x2 convs, one an output phase
(:func:`conv_folded_phase2_blocked`: the dense folded kernel is 25%
non-zero), and the doubly folded ``conv_last0`` as one matmul over its
taps and S*S shifted adds (:func:`conv_folded_tapmajor`), its input
channels permuted on the weight side (:func:`block_to_interleaved_perm`).
All are plain convs and matmuls, exact up to summation order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["fold_ps_conv", "fold_ps_bias", "conv_folded_phase2",
           "block_to_interleaved_perm", "conv_folded_phase2_blocked",
           "conv_folded_tapmajor"]


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


def _phase2_maps(x, folded, bias):
    """The four per-phase 2x2 convs of an r = 2 fold of a 3x3 kernel, in
    phase order i*2 + j: phase (i, j) reads folded taps rows i..i+1 and
    columns j..j+1, SAME-padded by (1 - i, i) and (1 - j, j).  x: (B, H,
    W, Cin) NHWC; folded: (3, 3, Cin, Cout) HWIO; each map (B, H, W,
    Cout / 4) in x's type."""
    if folded.shape[:2] != (3, 3):
        raise ValueError(f"a folded 3x3 kernel is 3x3, not "
                         f"{tuple(folded.shape[:2])}")
    xc = x.permute(0, 3, 1, 2)
    ys = []
    for i in range(2):
        for j in range(2):
            ph = i * 2 + j
            sub = folded[i:i + 2, j:j + 2, :, ph::4].to(x.dtype)
            y = F.conv2d(F.pad(xc, (1 - j, j, 1 - i, i)),
                         sub.permute(3, 2, 0, 1), bias[ph::4].to(x.dtype))
            ys.append(y.permute(0, 2, 3, 1))
    return ys


def conv_folded_phase2(x, folded, bias):
    """An r = 2-folded 3x3 conv as four per-phase 2x2 convs, channels
    interleaved back to the fold layout (channel ``c*4 + i*2 + j``): the
    dense conv's function with 4/9 of its taps.  x: (B, H, W, Cin);
    folded: (3, 3, Cin, Cout), Cout % 4 == 0; bias: (Cout,)."""
    b, h, w, _ = x.shape
    return torch.stack(_phase2_maps(x, folded, bias), -1).reshape(b, h, w, -1)


def block_to_interleaved_perm(cout: int, phases: int = 4) -> np.ndarray:
    """Index array p with ``blocked[..., k] == interleaved[..., p[k]]``: the
    fold layout has channel ``d*phases + ph``, the block layout ``ph*cb +
    d`` (cb = cout // phases).  ``w[:, :, p, :]`` makes a weight that reads
    the fold layout read the block layout."""
    cb = cout // phases
    ph, d = np.divmod(np.arange(cout), cb)
    return d * phases + ph


def conv_folded_phase2_blocked(x, folded, bias):
    """:func:`conv_folded_phase2` with phase-blocked output channels
    ``[phase0 | phase1 | phase2 | phase3]``, each Cout / 4 wide: no
    interleave; the consumer takes :func:`block_to_interleaved_perm` on its
    weight side."""
    return torch.cat(_phase2_maps(x, folded, bias), -1)


def conv_folded_tapmajor(x, folded, bias):
    """A folded SxS conv (S odd) as one (HW, Cin) x (Cin, S*S*Cout) matmul
    and S*S shifted adds of its Cout-wide tap maps, in float32 sums of the
    weight in x's type; the output in x's type.  x: (B, H, W, Cin);
    folded: (S, S, Cin, Cout); bias: (Cout,)."""
    s = folded.shape[0]
    m = (s - 1) // 2
    cin, cout = folded.shape[2], folded.shape[3]
    b, h, w, _ = x.shape
    wtap = folded.reshape(s * s, cin, cout).permute(1, 0, 2) \
        .reshape(cin, s * s * cout)
    p = torch.matmul(x.float(), wtap.to(x.dtype).float())
    p = F.pad(p.reshape(b, h, w, s * s, cout), (0, 0, 0, 0, m, m, m, m))
    out = bias.float().expand(b, h, w, cout)
    for dy in range(s):
        for dx in range(s):
            out = out + p[:, dy:dy + h, dx:dx + w, dy * s + dx]
    return out.to(x.dtype)
