"""Block DCT and the patch-grid ops of FTVSR (counterpart of
``fcvsr_tpu.ops.dct``).

The reference's 8x8 DCT layer is a stride-8 grouped conv with a fixed
cosine basis; here it is a reshape into blocks and one contraction with the
orthonormal basis, in the reference's channel order (c, u*8+v).  The
unfold / fold compositions of FTVSR's cross-scale features become
space-to-depth in ``unfold``'s (c, ky, kx) order and an index gather of
overlapping patches; adaptive average pooling is torch's own.  Every op
takes channels-last tensors and computes on their device, with no copy
from the host in a forward: the DCT basis is copied to a device once and
kept there, the index tables are made there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .resize import resize_bilinear

__all__ = ["dct_basis", "block_dct", "block_idct", "space_to_depth",
           "depth_to_space", "patch_grid", "adaptive_avg_pool",
           "pad_images_for_dct", "resize_flow"]


@functools.lru_cache(maxsize=None)
def _basis_np(n: int) -> np.ndarray:
    i = np.arange(n)
    basis_1d = np.cos(np.pi * np.outer(i, i + 0.5) / n) / np.sqrt(n)
    basis_1d[1:] *= np.sqrt(2.0)
    # filters[u, v, i, j] = b1d[u, i] * b1d[v, j]
    filt = np.einsum("ui,vj->uvij", basis_1d, basis_1d)
    return filt.reshape(n * n, n, n).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _basis(n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_basis_np(n)).to(device=device, dtype=dtype)


def dct_basis(n: int = 8, device=None, dtype=torch.float32) -> torch.Tensor:
    """(n*n, n, n) orthonormal 2-D DCT-II filters, indexed u*n + v: one
    tensor a (n, device, dtype), made on the first call; not to be written
    to."""
    return _basis(n, torch.device(device or "cpu"), dtype)


def space_to_depth(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/k, W/k, C*k*k), channels in the (c, ky, kx)
    order of torch ``unfold(k, stride=k)``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // k, k, w // k, k, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // k, w // k, c * k * k)


def depth_to_space(x: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of :func:`space_to_depth`."""
    b, hb, wb, ckk = x.shape
    c = ckk // (k * k)
    x = x.reshape(b, hb, wb, c, k, k).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, hb * k, wb * k, c)


def block_dct(x: torch.Tensor, n: int = 8) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/n, W/n, C*n*n) DCT coefficients, channel
    (c, u*n + v): the reference grouped conv's output order."""
    b, h, w, c = x.shape
    blocks = x.reshape(b, h // n, n, w // n, n, c).permute(0, 1, 3, 5, 2, 4)
    coeff = torch.einsum("bhwcij,kij->bhwck", blocks,
                         dct_basis(n, x.device, x.dtype))
    return coeff.reshape(b, h // n, w // n, c * n * n)


def block_idct(coeff: torch.Tensor, n: int = 8) -> torch.Tensor:
    """The inverse block DCT: (B, hb, wb, C*n*n) -> (B, hb*n, wb*n, C)."""
    b, hb, wb, cnn = coeff.shape
    c = cnn // (n * n)
    co = coeff.reshape(b, hb, wb, c, n * n)
    blocks = torch.einsum("bhwck,kij->bhwcij", co,
                          dct_basis(n, coeff.device, coeff.dtype))
    return blocks.permute(0, 1, 4, 2, 5, 3).reshape(b, hb * n, wb * n, c)


def _patch_index(size: int, k: int, stride: int, pad: int, device):
    nb = (size + 2 * pad - k) // stride + 1
    idx = torch.arange(nb, device=device)[:, None] * stride + \
        torch.arange(k, device=device)[None]
    return idx.reshape(-1)


def patch_grid(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """torch ``fold(unfold(x, k, pad, stride), (k*nb_h, k*nb_w), k,
    stride=k)``: the overlapping k x k patches laid side by side.
    (B, H, W, C) -> (B, nb_h*k, nb_w*k, C)."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    g = xp.index_select(1, _patch_index(h, k, stride, pad, x.device))
    return g.index_select(2, _patch_index(w, k, stride, pad, x.device))


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) adaptive average pooling with torch's windows
    [floor(i*in/out), ceil((i+1)*in/out))."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = F.adaptive_avg_pool2d(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                              (out_h, out_w))
    return y.permute(0, 2, 3, 1).reshape(lead + (out_h, out_w, c))


def pad_images_for_dct(imgs: torch.Tensor, n: int = 8):
    """FTVSR's ``check_and_padding_imgs``, quirks included: the frames are
    zero-padded to a multiple of n, then only the bottom-right corner block
    of the pad is copied from the frame (the rest of the pad stays zero),
    and nothing at all when either pad is 0.  imgs: (B, T, H, W, C).
    Returns (padded, pad_h, pad_w)."""
    h, w = imgs.shape[2:4]
    ph, pw = -h % n, -w % n
    out = F.pad(imgs, (0, 0, 0, pw, 0, ph))
    if ph > 0 and pw > 0:
        out = out.clone()
        out[:, :, -ph:, -pw:] = imgs[:, :, -ph:, -pw:]
    return out, ph, pw


def resize_flow(flow: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of a flow (B, H, W, 2), its (dx, dy) scaled by the
    size ratios (mmedit ``resize_flow``, size_type 'shape')."""
    h, w = flow.shape[1:3]
    out = resize_bilinear(flow, out_h, out_w)
    return torch.stack([out[..., 0] * (out_w / w), out[..., 1] * (out_h / h)],
                       -1)
