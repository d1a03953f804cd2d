"""No-reference quality metrics, NIQE and BRISQUE, in numpy and scipy
(counterpart of ``fcvsr_tpu.metrics.noref``):

* NIQE: MSCN coefficients and AGGD features over 96 x 96 blocks at two
  scales, the Mahalanobis distance to a pristine multivariate Gaussian
  whose (mu, cov) come from the released ``niqe_modelparameters.mat``
  (``calculate_niqe``'s ``params_path``).
* BRISQUE: GGD / AGGD features at two scales, scaled by the official
  feature ranges and scored by the released RBF-SVR, a torch ``.pth`` of
  (sv_coef, sv); gamma 0.05 and rho -153.591 are source-code constants of
  the reference, as here.

Both use MATLAB's ``imresize`` (antialiased cubic, a = -0.5, symmetric
boundary), implemented here exactly.  NRQM and PI are in ``metrics.nrqm``.
The luma conversions are the port's ``metrics.psnr_ssim``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
from scipy.ndimage import convolve as nd_convolve
from scipy.special import gamma as sp_gamma

from .psnr_ssim import bgr2y, rgb2y

__all__ = ["matlab_imresize", "calculate_niqe", "calculate_brisque",
           "niqe_features", "brisque_features"]


# --------------------------- matlab imresize -------------------------------


def _cubic_matlab(x):
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


@functools.lru_cache(maxsize=None)
def _imresize_weights(in_len: int, out_len: int, scale: float):
    kernel_width = 4.0
    if scale < 1:
        kernel_width /= scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(math.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None]
    dist = u[:, None] - idx
    if scale < 1:
        w = scale * _cubic_matlab(dist * scale)
    else:
        w = _cubic_matlab(dist)
    w = w / np.sum(w, axis=1, keepdims=True)
    # symmetric boundary indices
    aux = np.concatenate([np.arange(in_len), np.arange(in_len - 1, -1, -1)])
    idx_clamped = aux[np.mod(idx.astype(np.int64) - 1, 2 * in_len)]
    # drop all-zero weight columns
    keep = ~np.all(w == 0, axis=0)
    return w[:, keep], idx_clamped[:, keep]


def matlab_imresize(img: np.ndarray, scale: float | None = None,
                    sizes: tuple | None = None) -> np.ndarray:
    """MATLAB imresize with bicubic kernel + antialiasing, 2-D input.

    Either ``scale`` (both dims) or ``sizes`` (target (h, w); per-dimension
    scale = out/in, MATLAB convention) must be given.
    """
    h, w = img.shape[:2]
    if sizes is not None:
        oh, ow = int(sizes[0]), int(sizes[1])
        sh, sw = oh / h, ow / w
    else:
        oh, ow = int(math.ceil(h * scale)), int(math.ceil(w * scale))
        sh = sw = scale
    wh, ih = _imresize_weights(h, oh, sh)
    out = np.einsum("ok,okw->ow", wh, img[ih, :])
    ww, iw = _imresize_weights(w, ow, sw)
    out = np.einsum("ok,hok->ho", ww, out[:, iw])
    return out


# ------------------------------ features -----------------------------------


@functools.lru_cache(maxsize=None)
def _gamma_lut():
    gam = np.arange(0.2, 10.001, 0.001)
    rec = 1.0 / gam
    r_aggd = np.square(sp_gamma(rec * 2)) / (sp_gamma(rec) * sp_gamma(rec * 3))
    r_ggd = sp_gamma(rec) * sp_gamma(3 * rec) / np.square(sp_gamma(2 * rec))
    return gam, r_aggd, r_ggd


def _estimate_aggd(block: np.ndarray):
    gam, r_gam, _ = _gamma_lut()
    block = block.flatten()
    left = block[block < 0]
    right = block[block > 0]
    left_std = np.sqrt(np.mean(left ** 2)) if left.size else 0.0
    right_std = np.sqrt(np.mean(right ** 2)) if right.size else 0.0
    gammahat = left_std / right_std if right_std > 0 else np.inf
    rhat = (np.mean(np.abs(block))) ** 2 / np.mean(block ** 2)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / (
        (gammahat ** 2 + 1) ** 2)
    pos = np.argmin((r_gam - rhatnorm) ** 2)
    alpha = gam[pos]
    ratio = np.sqrt(sp_gamma(1 / alpha) / sp_gamma(3 / alpha))
    return alpha, left_std * ratio, right_std * ratio


def _estimate_ggd(block: np.ndarray):
    gam, _, r_ggd = _gamma_lut()
    block = block.flatten()
    sigma_sq = np.mean(block ** 2)
    e_abs = np.mean(np.abs(block))
    rho = sigma_sq / (e_abs ** 2) if e_abs > 0 else np.inf
    pos = np.argmin(np.abs(r_ggd - rho))
    return gam[pos], np.sqrt(sigma_sq)


@functools.lru_cache(maxsize=None)
def _gaussian_window(size: int = 7, sigma: float = 7.0 / 6.0):
    i = np.arange(size) - size // 2
    g = np.exp(-(i ** 2) / (2 * sigma * sigma))
    w = np.outer(g, g)
    return w / w.sum()


def _mscn(img: np.ndarray) -> np.ndarray:
    win = _gaussian_window()
    mu = nd_convolve(img, win, mode="nearest")
    sigma = np.sqrt(np.abs(nd_convolve(img ** 2, win, mode="nearest") - mu ** 2))
    return (img - mu) / (sigma + 1)


def _block_features(block: np.ndarray) -> list:
    feat = []
    alpha, bl, br = _estimate_aggd(block)
    feat.extend([alpha, (bl + br) / 2])
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        prod = block * np.roll(block, shift, axis=(0, 1))
        alpha, bl, br = _estimate_aggd(prod)
        mean = (br - bl) * (sp_gamma(2 / alpha) / sp_gamma(1 / alpha))
        feat.extend([alpha, mean, bl, br])
    return feat


def niqe_features(img: np.ndarray, block: int = 96) -> np.ndarray:
    """Per-block 36-dim NIQE features over two scales; img (H, W) in [0,255]."""
    h, w = img.shape
    nbh, nbw = h // block, w // block
    img = img[: nbh * block, : nbw * block].astype(np.float64)
    per_scale = []
    for scale in (1, 2):
        norm = _mscn(img)
        feats = []
        for iw in range(nbw):
            for ih in range(nbh):
                bs = block // scale
                feats.append(_block_features(
                    norm[ih * bs : (ih + 1) * bs, iw * bs : (iw + 1) * bs]))
        per_scale.append(np.asarray(feats))
        if scale == 1:
            img = matlab_imresize(img / 255.0, 0.5) * 255.0
    return np.concatenate(per_scale, axis=1)


def calculate_niqe(img, params_path: str, crop_border: int = 0,
                   convert_to: str = "y", channel_order: str = "bgr") -> float:
    """NIQE score; ``params_path`` is an niqe_modelparameters.mat file
    providing the pristine (mu, cov)."""
    import scipy.io

    m = scipy.io.loadmat(params_path)
    mu_pris = np.asarray(m["mu_prisparam"]).reshape(-1)
    cov_pris = np.asarray(m["cov_prisparam"])

    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        if convert_to == "y":
            img = bgr2y(img) if channel_order == "bgr" else rgb2y(img)
        else:
            img = img.mean(-1)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    img = np.round(img)

    feats = niqe_features(img)
    mu_dist = np.nanmean(feats, axis=0)
    ok = feats[~np.isnan(feats).any(axis=1)]
    cov_dist = np.cov(ok, rowvar=False)
    inv = np.linalg.pinv((cov_pris + cov_dist) / 2)
    d = mu_pris - mu_dist
    return float(np.sqrt(d @ inv @ d))


# ------------------------------ BRISQUE ------------------------------------

# Official BRISQUE release feature scaling ranges (allmodel, LIVE lab).
_BRISQUE_RANGES = np.array([
    [0.338, 10], [0.017204, 0.806612], [0.236, 1.642], [-0.123884, 0.20293],
    [0.000155, 0.712298], [0.001122, 0.470257], [0.244, 1.641],
    [-0.123586, 0.179083], [0.000152, 0.710456], [0.000975, 0.470984],
    [0.249, 1.555], [-0.135687, 0.100858], [0.000174, 0.684173],
    [0.000913, 0.534174], [0.258, 1.561], [-0.143408, 0.100486],
    [0.000179, 0.685696], [0.000888, 0.536508], [0.471, 3.264],
    [0.012809, 0.703171], [0.218, 1.046], [-0.094876, 0.187459],
    [1.5e-05, 0.442057], [0.001272, 0.40803], [0.222, 1.042],
    [-0.115772, 0.162604], [1.6e-05, 0.444362], [0.001374, 0.40243],
    [0.227, 0.996], [-0.117188, 0.098323], [3e-05, 0.531903],
    [0.001122, 0.369589], [0.228, 0.99], [-0.12243, 0.098658],
    [2.8e-05, 0.530092], [0.001118, 0.370399]])


def brisque_features(img: np.ndarray) -> np.ndarray:
    """36-dim BRISQUE features; img (H, W) luma in [0, 255]."""
    img = img.astype(np.float64)
    feats = []
    for _ in range(2):
        norm = _mscn(img)
        alpha, sigma = _estimate_ggd(norm)
        f = [alpha, sigma ** 2]
        for shift in ((0, 1), (1, 0), (1, 1), (-1, 1)):
            prod = norm * np.roll(norm, shift, axis=(0, 1))
            a, bl, br = _estimate_aggd(prod)
            mean = (br - bl) * (sp_gamma(2 / a) / sp_gamma(1 / a))
            f.extend([a, mean, bl ** 2, br ** 2])
        feats.extend(f)
        img = matlab_imresize(img / 255.0, 0.5) * 255.0
    return np.asarray(feats)


def calculate_brisque(img, svm_path: str, convert_to: str = "y",
                      channel_order: str = "bgr") -> float:
    """BRISQUE score with the released SVR weights (.pth with (sv_coef, sv))."""
    import torch

    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        if convert_to == "y":
            img = bgr2y(img) if channel_order == "bgr" else rgb2y(img)
        else:
            img = img.mean(-1)

    feats = brisque_features(img)
    scaled = -1 + 2 * (feats - _BRISQUE_RANGES[:, 0]) / (
        _BRISQUE_RANGES[:, 1] - _BRISQUE_RANGES[:, 0])

    sv_coef, sv = torch.load(svm_path, map_location="cpu", weights_only=False)
    sv_coef = sv_coef.numpy().reshape(-1)
    sv = sv.numpy()  # (n_sv, 36) or (36, n_sv)
    if sv.shape[0] == 36:
        sv = sv.T
    gamma_svm = 0.05
    rho = -153.591
    dist = np.sum((scaled[None, :] - sv) ** 2, axis=1)
    kernel = np.exp(-gamma_svm * dist)
    return float(kernel @ sv_coef - rho)
