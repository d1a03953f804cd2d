"""PSNR / SSIM evaluation matching the reference metric drivers (the port's
own copy of ``fcvsr_tpu.metrics.psnr_ssim``).

Semantics pinned to mmedit ``core/evaluation/metrics.py`` (psnr:170, ssim:253)
and ``CVSR_train/metric/psnr_ssim.py``:

* images are float arrays in [0, 255];
* Y conversion is mmcv ``bgr2ycbcr(img/255, y_only=True) * 255`` —
  Y = dot(BGR/255, [24.966, 128.553, 65.481]) + 16;
* SSIM uses the MATLAB 11x11 Gaussian (sigma 1.5) window, per-channel, with a
  5-pixel crop after filtering (== 'valid' correlation — the reference's
  reflect-border filtering never reaches the kept region);
* PSNR: 20*log10(255/sqrt(mse)).

Pure numpy — metrics run host-side over decoded PNG frames.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bgr2y", "rgb2y", "calculate_psnr", "calculate_ssim"]


def bgr2y(img255: np.ndarray) -> np.ndarray:
    """BGR [0,255] HWC -> Y [16,235] HW (mmcv bgr2ycbcr y_only semantics)."""
    img = img255.astype(np.float32) / 255.0
    return img @ np.array([24.966, 128.553, 65.481], np.float32) + 16.0


def rgb2y(img255: np.ndarray) -> np.ndarray:
    """RGB [0,255] HWC -> Y [16,235] HW."""
    img = img255.astype(np.float32) / 255.0
    return img @ np.array([65.481, 128.553, 24.966], np.float32) + 16.0


def _prepare(img1, img2, crop_border, convert_to, channel_order):
    img1 = np.asarray(img1, np.float32)
    img2 = np.asarray(img2, np.float32)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    if isinstance(convert_to, str) and convert_to.lower() == "y":
        conv = bgr2y if channel_order == "bgr" else rgb2y
        img1 = conv(img1)[..., None]
        img2 = conv(img2)[..., None]
    elif convert_to is not None:
        raise ValueError("convert_to must be 'Y' or None")
    if crop_border != 0:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    return img1, img2


def calculate_psnr(img1, img2, crop_border=0, convert_to=None,
                   channel_order="bgr") -> float:
    """PSNR between two [0,255] images (HWC or HW)."""
    img1, img2 = _prepare(img1, img2, crop_border, convert_to, channel_order)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / np.sqrt(mse)))


def _gaussian_kernel_11() -> np.ndarray:
    """cv2.getGaussianKernel(11, 1.5): normalised exp(-(i-5)^2 / (2*1.5^2))."""
    i = np.arange(11, dtype=np.float64) - 5.0
    k = np.exp(-(i ** 2) / (2.0 * 1.5 ** 2))
    return k / k.sum()


def _valid_sep_filter(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' correlation with a symmetric 1-D kernel."""
    n = len(k)
    # filter rows
    out = np.zeros((img.shape[0] - n + 1, img.shape[1]), np.float64)
    for t in range(n):
        out += k[t] * img[t : t + out.shape[0], :]
    out2 = np.zeros((out.shape[0], img.shape[1] - n + 1), np.float64)
    for t in range(n):
        out2 += k[t] * out[:, t : t + out2.shape[1]]
    return out2


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    k = _gaussian_kernel_11()
    mu1 = _valid_sep_filter(img1, k)
    mu2 = _valid_sep_filter(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _valid_sep_filter(img1 ** 2, k) - mu1_sq
    sigma2_sq = _valid_sep_filter(img2 ** 2, k) - mu2_sq
    sigma12 = _valid_sep_filter(img1 * img2, k) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


def calculate_ssim(img1, img2, crop_border=0, convert_to=None,
                   channel_order="bgr") -> float:
    """Per-channel-averaged MATLAB-style SSIM on [0,255] images."""
    img1, img2 = _prepare(img1, img2, crop_border, convert_to, channel_order)
    return float(np.mean([_ssim_single(img1[..., i], img2[..., i])
                          for i in range(img1.shape[-1])]))
