"""Frequency-domain helpers (counterpart of ``fcvsr_tpu.ops.freq``).

* :func:`rfft_features` packs ``rfft2(norm='backward')`` as [imag, real]
  along channels (reference MGAA packing); ``groups=g`` interleaves it per
  group, [imag_g, real_g] * g, as the JAX op does for MGAA's three groups.
* :func:`irfft_features` unpacks real-first (the reference's asymmetric
  unpack): first channel half real, second half imaginary.
* :func:`gaussian_band_masks` / :func:`split_freq` are the MFFR band split:
  concentric Gaussian rings built on a 1024 x 1024 grid, bicubic-resized to
  (H, W) with torch, applied to the 2-D spectrum.

All transforms are ``torch.fft`` in float32 / complex64.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["rfft_features", "irfft_features", "gaussian_band_masks",
           "split_freq"]


def rfft_features(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """(B, H, W, C) real -> (B, H, W//2+1, 2C), channels [imag, real] per
    group of C/groups channels."""
    c = x.shape[-1]
    if c % groups:
        raise ValueError(f"C={c} is not a multiple of groups={groups}")
    g = c // groups
    f = torch.fft.rfft2(x.float(), dim=(1, 2), norm="backward")
    im, re = f.imag, f.real
    parts = []
    for i in range(groups):
        parts += [im[..., i * g:(i + 1) * g], re[..., i * g:(i + 1) * g]]
    return torch.cat(parts, dim=-1).to(x.dtype)


def irfft_features(xf: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, Wf, 2C) -> (B, H, W, C): irfft2 of complex(first half, second
    half) with output size (h, w)."""
    c2 = xf.shape[-1]
    xf32 = xf.float()
    f = torch.complex(xf32[..., :c2 // 2], xf32[..., c2 // 2:])
    out = torch.fft.irfft2(f, s=(h, w), dim=(1, 2), norm="backward")
    return out.to(xf.dtype)


@functools.lru_cache(maxsize=None)
def _band_masks_1024(num_bands: int) -> torch.Tensor:
    """(K, 1024, 1024) fftshift-centred Gaussian bands: band k is the k-th
    Gaussian low-pass minus all previous bands."""
    size = 1024
    interval = math.sqrt((size / 2) ** 2 + (size / 2) ** 2) / num_bands
    d2 = (np.arange(size) - size // 2).astype(np.float64) ** 2
    dist2 = d2[:, None] + d2[None, :]
    bands = []
    for n in range(num_bands):
        pf = np.exp(-dist2 / (2.0 * (interval * (n + 1)) ** 2))
        pf = torch.from_numpy(pf.astype(np.float32))
        for prev in bands:
            pf = pf - prev
        bands.append(pf)
    return torch.stack(bands)


@functools.lru_cache(maxsize=None)
def gaussian_band_masks(num_bands: int, h: int, w: int):
    """(shifted, centered) masks, each (K, h, w) float32 on the CPU.

    ``centered`` is the 1024-grid masks resized with torch bicubic
    (align_corners=False, no antialias); ``shifted`` is it ifftshifted, for
    direct multiplication with an unshifted fft2."""
    centered = F.interpolate(_band_masks_1024(num_bands)[None], size=(h, w),
                             mode="bicubic", align_corners=False)[0]
    shifted = torch.fft.ifftshift(centered, dim=(1, 2))
    return shifted.contiguous(), centered


@functools.lru_cache(maxsize=16)
def _masks_on(num_bands: int, h: int, w: int, device: torch.device):
    shifted, _ = gaussian_band_masks(num_bands, h, w)
    return shifted.to(device)


def split_freq(x: torch.Tensor, num_bands: int) -> torch.Tensor:
    """Split (B, H, W, C) into (K, B, H, W, C) Gaussian frequency bands:
    band k = real(ifft2(fft2(x) * mask_k))."""
    b, h, w, c = x.shape
    m = _masks_on(num_bands, h, w, x.device)
    xf = torch.fft.fft2(x.float(), dim=(1, 2))
    prod = xf.unsqueeze(0) * m[:, None, :, :, None]
    return torch.fft.ifft2(prod, dim=(2, 3)).real.to(x.dtype)
