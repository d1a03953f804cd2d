"""Frequency-feature correlation lookup (counterpart of
``fcvsr_tpu.ops.corr``; bug-compatible reference CorrBlock).

The reference multiplies the two features elementwise, reinterprets the
contiguous (B, C, H*W) buffer as (B, H, W, C//2, 2) - a raw memory reshape
with no semantic transpose - and samples a (2r+1)^2 integer neighbourhood of
each per-pixel (C//2, 2) map with zero padding.  Only the corner
h < C//2 + r, w < r + 2 can be non-zero, so only it is computed, by direct
indexing.  Channels-last in, (B, H, W, (2r+1)^2) out.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["corr_lookup"]


@functools.lru_cache(maxsize=None)
def _lookup_index(hc: int, wc: int, half_c: int, radius: int):
    """(i, j, valid) index tables of shape (hc, wc, Q).

    Query q reads the (C//2, 2) map at (h + q % n - r, w + q // n - r): the
    reference adds its (dy, dx)-ordered delta grid to (x, y)-ordered
    coordinates, so the query grid's row offsets x and its column y."""
    n = 2 * radius + 1
    q = np.arange(n * n)
    ii = np.arange(hc)[:, None, None] + (q % n - radius)[None, None, :]
    jj = np.arange(wc)[None, :, None] + (q // n - radius)[None, None, :]
    ii, jj = np.broadcast_arrays(ii, jj)
    valid = (ii >= 0) & (ii < half_c) & (jj >= 0) & (jj < 2)
    return (torch.from_numpy(np.clip(ii, 0, half_c - 1)),
            torch.from_numpy(np.clip(jj, 0, 1)),
            torch.from_numpy(valid.astype(np.float32)))


def corr_lookup(f1: torch.Tensor, f2: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """(B, H, W, C) x 2 -> (B, H, W, (2r+1)^2) correlation feature."""
    b, h, w, c = f1.shape
    half_c = c // 2
    hc = min(h, half_c + radius)
    wc = min(w, radius + 2)
    # the corner rows read only the first n_elems values of the NCHW buffer,
    # i.e. its first c_needed channels
    n_elems = hc * w * half_c * 2
    c_needed = min(c, -(-n_elems // (h * w)))
    prod = (f1[..., :c_needed] * f2[..., :c_needed]) * (1.0 / math.sqrt(c))
    buf = prod.permute(0, 3, 1, 2).reshape(b, c_needed * h * w)
    r6 = buf[:, :n_elems].reshape(b, hc, w, half_c, 2)[:, :, :wc]
    ii, jj, valid = (t.to(f1.device) for t in
                     _lookup_index(hc, wc, half_c, radius))
    hh = torch.arange(hc, device=f1.device)[:, None, None]
    ww = torch.arange(wc, device=f1.device)[None, :, None]
    corner = r6[:, hh, ww, ii, jj] * valid.to(prod.dtype)
    out = prod.new_zeros((b, h, w, corner.shape[-1]))
    out[:, :hc, :wc] = corner
    return out
