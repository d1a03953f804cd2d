"""NRQM (Ma et al., CVIU 2017) and the perceptual index PI, in numpy
(counterpart of ``fcvsr_tpu.metrics.nrqm``, after the MATLAB sr-metric
release):

1. The Y image -> a 3-level Gaussian pyramid (fspecial(3, 0.5) blur,
   stride-2 decimation from index 1).
2. Three feature families:
   * f1 (18): 7 x 7 stride-3 block-DCT statistics a pyramid level, the
     generalized-Gaussian shape ``gamma`` (table inversion of var /
     mean|x - mu|^2), the coefficient of variation and the 3-orientation
     energy variance, each as the mean of its sorted top or bottom 10 % and
     the full mean;
   * f2 (45): a complex steerable pyramid (2 scales x 6 orientations),
     divisive normalisation with neighbour and parent conditioning, then
     GGD gammas (12 + 6 across scales) and SSIM-CS structural correlations
     (12 against the high-pass residual, 15 orientation pairs);
   * f3 (75): the singular values of the 5 x 5 distinct-block matrix a
     level.
3. Three random forests (one a family) and a linear blend, from the
   released ``NRQM_model.mat`` (not bundled: scoring needs the file, the
   features do not).

PI = 0.5 ((10 - NRQM) + NIQE), NIQE with crop_border 4.  Everything is
float64; the steerable pyramid's masks are cast to float32 as the reference
casts them.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np

from .noref import _gaussian_window, calculate_niqe, matlab_imresize

__all__ = [
    "nrqm_features", "calculate_nrqm", "calculate_pi",
    "random_forest_predict", "gamma_gen_gauss", "scf_pyramid",
]

_EPS = 1e-7


# ----------------------------- primitives ----------------------------------


@functools.lru_cache(maxsize=None)
def _gamma_table():
    g = np.arange(0.03, 10 + 0.001, 0.001)
    from scipy.special import gammaln
    r = np.exp(gammaln(1.0 / g) + gammaln(3.0 / g) - 2 * gammaln(2.0 / g))
    return g, r


def gamma_gen_gauss(x: np.ndarray) -> np.ndarray:
    """GGD shape parameter per row of ``x`` (..., N) via table inversion.

    Mirrors nrqm.py:1621-1650: rho = var_unbiased / (mean|x - mu|)^2,
    nearest entry in the r(gamma) table for gamma in [0.03, 10] step 0.001.
    """
    gamma, r_table = _gamma_table()
    mean = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, ddof=1)
    mean_abs = np.abs(x - mean).mean(axis=-1) ** 2
    rho = var / (mean_abs + _EPS)
    idx = np.abs(rho[..., None] - r_table).argmin(axis=-1)
    return gamma[idx]


def _var_gen_gauss(x: np.ndarray, eps: float = _EPS) -> np.ndarray:
    """Coefficient of variation of |x| over the last axis (nrqm.py:1606)."""
    ax = np.abs(x)
    std = ax.std(axis=-1, ddof=1)
    return std / (ax.mean(axis=-1) + eps)


@functools.lru_cache(maxsize=None)
def _dct_mat(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (scipy.fftpack.dct norm='ortho')."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2.0)
    return m


def _dct2(blocks: np.ndarray) -> np.ndarray:
    """2-D orthonormal DCT over the last two axes."""
    m = _dct_mat(blocks.shape[-2])
    n = _dct_mat(blocks.shape[-1])
    return np.einsum("ij,...jk,lk->...il", m, blocks, n)


def _fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    m = (size - 1) / 2.0
    y, x = np.mgrid[-m:m + 1, -m:m + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h / h.sum()


def _conv2_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """2-D correlation, 'valid' output (filter2 semantics on a symmetric k)."""
    kh, kw = k.shape
    win = _sliding_patches(img, kh, 1)  # (oh, ow, kh, kw) with oh=H-kh+1
    return np.einsum("hwij,ij->hw", win, k)


def _sliding_patches(img: np.ndarray, ksize: int, stride: int) -> np.ndarray:
    h, w = img.shape
    oh = (h - ksize) // stride + 1
    ow = (w - ksize) // stride + 1
    s0, s1 = img.strides
    from numpy.lib.stride_tricks import as_strided
    return as_strided(img, (oh, ow, ksize, ksize),
                      (s0 * stride, s1 * stride, s0, s1))


def _same_pad_patches(img: np.ndarray, ksize: int, stride: int) -> np.ndarray:
    """7x7-style patch extraction with tensorflow-'same' zero padding
    (nrqm.py:840-906 extract_2d_patches + exact_padding_2d)."""
    h, w = img.shape
    oh, ow = math.ceil(h / stride), math.ceil(w / stride)
    pad_row = (oh - 1) * stride + ksize - h
    pad_col = (ow - 1) * stride + ksize - w
    img = np.pad(img, ((pad_row // 2, pad_row - pad_row // 2),
                       (pad_col // 2, pad_col - pad_col // 2)))
    return _sliding_patches(img, ksize, stride).reshape(-1, ksize, ksize)


def _im2col_distinct(img: np.ndarray, ksize: int) -> np.ndarray:
    """Distinct (non-overlapping) blocks as rows, zero-padded right/bottom,
    column-major block order as torch unfold produces (nrqm.py:974-1007)."""
    h, w = img.shape
    oh, ow = math.ceil(h / ksize), math.ceil(w / ksize)
    img = np.pad(img, ((0, oh * ksize - h), (0, ow * ksize - w)))
    blocks = _sliding_patches(img, ksize, ksize)  # (oh, ow, k, k)
    return blocks.reshape(oh * ow, ksize * ksize)


# --------------------------- f1: block DCT ----------------------------------


def _gauss_pyramid(img: np.ndarray, levels: int = 2) -> list[np.ndarray]:
    """[img, down2(img), down4(img)] with fspecial(3, .5) blur, zero 'same'
    padding, and [1::2, 1::2] decimation (nrqm.py:1588-1599).

    The reference quantizes the kernel to float32 (fspecial -> .float());
    we reproduce that for bit-parity."""
    k = _fspecial_gauss(3, 0.5).astype(np.float32).astype(np.float64)
    pyr = [img]
    cur = img
    for _ in range(levels):
        blurred = _conv2_valid(np.pad(cur, 1), k)
        cur = blurred[1::2, 1::2]
        pyr.append(cur)
    return pyr


def _oriented_sets(n: int = 7):
    """Index sets of the three DCT orientation groups (nrqm.py:1669-1706)."""
    o1 = [(0, j) for j in range(1, n)] + [(1, j) for j in range(2, n)] + \
         [(2, j) for j in range(4, n)] + [(3, j) for j in range(5, n)]
    o2 = [(1, 1)] + [(2, j) for j in range(2, 4)] + \
         [(3, j) for j in range(2, 5)] + [(4, j) for j in range(3, n)] + \
         [(5, j) for j in range(4, n)] + [(6, j) for j in range(4, n)]
    o3 = [(i, 0) for i in range(1, n)] + [(i, 1) for i in range(2, n)] + \
         [(i, 2) for i in range(4, n)] + [(i, 3) for i in range(5, n)]
    return o1, o2, o3


def _block_dct_features(img: np.ndarray) -> np.ndarray:
    """6 DCT statistics for one pyramid level (nrqm.py:1715-1743)."""
    d = _dct2(_same_pad_patches(img, 7, 3))          # (P, 7, 7)
    flat = d.reshape(d.shape[0], 49)[:, 1:]          # drop DC

    feats = []
    g = np.sort(gamma_gen_gauss(flat))
    feats += [g[: math.ceil(0.1 * g.shape[-1]) + 1].mean(), g.mean()]

    cv = np.sort(_var_gen_gauss(flat, _EPS))
    feats += [cv[math.floor(0.9 * cv.shape[-1]):].mean(), cv.mean()]

    o1, o2, o3 = _oriented_sets()
    gs = [
        _var_gen_gauss(np.stack([d[:, i, j] for i, j in o], axis=-1), 1e-8)
        for o in (o1, o2, o3)
    ]
    rho = np.sort(np.stack(gs, axis=-1).var(axis=-1, ddof=1))
    feats += [rho[math.floor(0.9 * rho.shape[-1]):].mean(), rho.mean()]
    return np.array(feats)


# ----------------- f2: complex steerable pyramid + GSM ----------------------


def _prepare_grid(m: int, n: int):
    x = np.linspace(-(m // 2) / (m / 2), (m // 2) / (m / 2) - (1 - m % 2) * 2 / m, num=m)
    y = np.linspace(-(n // 2) / (n / 2), (n // 2) / (n / 2) - (1 - n % 2) * 2 / n, num=n)
    xv, yv = np.meshgrid(y, x)
    angle = np.arctan2(yv, xv)
    rad = np.sqrt(xv ** 2 + yv ** 2)
    rad[m // 2][n // 2] = rad[m // 2][n // 2 - 1]
    return np.log2(rad), angle


def _rcos_fn(width: float, position: float):
    n = 256
    x = np.pi * np.arange(-n - 1, 2) / 2 / n
    y = np.cos(x) ** 2
    y[0] = y[1]
    y[n + 2] = y[n + 1]
    return position + 2 * width / np.pi * (x + np.pi / 4), y


def _point_op(im: np.ndarray, y: np.ndarray, x: np.ndarray) -> np.ndarray:
    return np.interp(im.ravel(), x, y).reshape(im.shape)


def scf_pyramid(img: np.ndarray, height: int = 2, nbands: int = 6):
    """Complex steerable pyramid of a 2-D image (SCFpyr, nrqm.py:1149-1306).

    Returns [hi0 (real H x W), [band0..band5] complex at full res,
    [band0..band5] complex at half res, ..., lowpass real].
    """
    from scipy.special import factorial

    h, w = img.shape
    if height > int(np.floor(np.log2(min(h, w))) - 2):
        raise ValueError("image too small for pyramid height")

    log_rad, angle = _prepare_grid(h, w)
    xrcos, yrcos = _rcos_fn(1, -0.5)
    yrcos = np.sqrt(yrcos)
    yircos = np.sqrt(1 - yrcos ** 2)
    lo0mask = _point_op(log_rad, yircos, xrcos).astype(np.float32)
    hi0mask = _point_op(log_rad, yrcos, xrcos).astype(np.float32)

    dft = np.fft.fftshift(np.fft.fft2(img))
    lodft = dft * lo0mask

    lutsize = 1024
    xcosn = np.pi * np.arange(-(2 * lutsize + 1), lutsize + 2) / lutsize
    alpha = (xcosn + np.pi) % (2 * np.pi) - np.pi
    order = nbands - 1
    const = (2 ** (2 * order)) * (factorial(order) ** 2) / (nbands * factorial(2 * order))
    ycosn = 2 * np.sqrt(const) * np.cos(xcosn) ** order * (np.abs(alpha) < np.pi / 2)
    cfact = np.power(complex(0, -1), nbands - 1)

    levels = []
    for _ in range(height):
        xrcos = xrcos - np.log2(2.0)
        himask = _point_op(log_rad, yrcos, xrcos).astype(np.float32)
        bands = []
        for b in range(nbands):
            anglemask = _point_op(angle, ycosn, xcosn + np.pi * b / nbands)
            banddft = lodft * anglemask.astype(np.float32) * himask * cfact
            bands.append(np.fft.ifft2(np.fft.ifftshift(banddft)))
        levels.append(bands)

        dims = np.array(lodft.shape)
        lo_start = (np.ceil((dims + 0.5) / 2)
                    - np.ceil((np.ceil((dims - 0.5) / 2) + 0.5) / 2)).astype(int)
        lo_end = (lo_start + np.ceil((dims - 0.5) / 2)).astype(int)
        log_rad = log_rad[lo_start[0]:lo_end[0], lo_start[1]:lo_end[1]]
        angle = angle[lo_start[0]:lo_end[0], lo_start[1]:lo_end[1]]
        lodft = lodft[lo_start[0]:lo_end[0], lo_start[1]:lo_end[1]]
        lomask = _point_op(log_rad, np.abs(np.sqrt(1 - yrcos ** 2)), xrcos)
        lodft = lodft * lomask.astype(np.float32)

    lowpass = np.real(np.fft.ifft2(np.fft.ifftshift(lodft)))
    hi0 = np.real(np.fft.ifft2(np.fft.ifftshift(dft * hi0mask)))
    return [hi0] + levels + [lowpass]


def _norm_sender_normalized(bands: list[np.ndarray], num_scale: int = 2,
                            num_bands: int = 6) -> list[np.ndarray]:
    """Divisive normalization with neighbour/parent conditioning
    (nrqm.py:1746-1810).  ``bands``: 12 real subbands, scale-major."""
    border, guard = 1, 16
    out = []
    for si in range(num_scale):
        for bi in range(num_bands):
            idx = si * num_bands + bi
            band = bands[idx]
            n_taps = 9
            cols = [_sliding_patches(band, 3, 1).reshape(-1, 9)]
            parent_idx = idx + num_bands
            if parent_idx < len(bands):
                par = matlab_imresize(bands[parent_idx], sizes=band.shape)
                cols.append(par[border:-border, border:-border].reshape(-1, 1))
                n_taps += 1
            for ni in range(num_bands):
                if ni != bi:
                    nb = bands[si * num_bands + ni]
                    cols.append(nb[border:-border, border:-border].reshape(-1, 1))
            tmp = np.concatenate(cols, axis=-1)          # (hw, taps)

            c_x = tmp.T @ tmp / tmp.shape[0]
            lam, q = np.linalg.eigh(c_x)
            lam_pos = lam * (lam > 0)
            pos_sum = lam_pos.sum()
            lam = lam_pos * lam.sum() / (pos_sum + (pos_sum == 0))
            c_x = q @ np.diag(lam) @ q.T

            o_c = band[border:-border, border:-border]
            h, w = o_c.shape
            o_c = o_c.reshape(-1) - o_c.mean()

            tmp_y = np.linalg.lstsq(c_x.T, tmp.T, rcond=None)[0].T * tmp / n_taps
            z = np.sqrt(tmp_y.sum(axis=-1))
            mask = z != 0
            g_c = (o_c * mask / (z * mask + 1e-12)).reshape(h, w)

            gb = int(guard / (2 ** si))
            g_c = g_c[gb:-gb, gb:-gb]
            out.append(g_c - g_c.mean())
    return out


def _ssim_cs(x: np.ndarray, y: np.ndarray, data_range: float = 255.0) -> float:
    """Mean contrast-structure component of SSIM, 'valid' 11x11 gaussian
    window, relu-clamped (nrqm.py:120-167 with get_cs=True)."""
    win = _gaussian_window(11, 1.5)
    win = win / win.sum()
    c2 = (0.03 * data_range) ** 2
    mu1 = _conv2_valid(x, win)
    mu2 = _conv2_valid(y, win)
    s1 = _conv2_valid(x * x, win) - mu1 ** 2
    s2 = _conv2_valid(y * y, win) - mu2 ** 2
    s12 = _conv2_valid(x * y, win) - mu1 * mu2
    cs = (2 * s12 + c2) / (s1 + s2 + c2)
    return float(np.maximum(cs, 0).mean())


def _gsm_features(img: np.ndarray) -> np.ndarray:
    """45 global GSM features (nrqm.py:1812-1856)."""
    nb = 6
    pyr = scf_pyramid(img, height=2, nbands=nb)
    lp_bands = [np.real(b) for b in pyr[1]] + [np.real(b) for b in pyr[2]]
    subbands = _norm_sender_normalized(lp_bands)

    feats = [float(gamma_gen_gauss(sb.reshape(1, -1))[0]) for sb in subbands]
    for i in range(nb):
        both = np.concatenate([subbands[i].ravel(), subbands[i + nb].ravel()])
        feats.append(float(gamma_gen_gauss(both[None])[0]))

    hp = pyr[0]
    for sb in lp_bands:
        cur = matlab_imresize(sb, sizes=hp.shape)
        feats.append(_ssim_cs(cur, hp))
    for i in range(nb):
        for j in range(i + 1, nb):
            feats.append(_ssim_cs(subbands[i], subbands[j]))
    return np.array(feats)


# ------------------------------ features ------------------------------------


def nrqm_features(img: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(f1 (18,), f2 (45,), f3 (75,)) for a grayscale/Y image in [0, 255]."""
    img = np.asarray(img, np.float64)
    pyr = _gauss_pyramid(img / 255.0)
    f1 = np.concatenate([_block_dct_features(im) for im in pyr])
    f2 = _gsm_features(img)
    f3 = np.concatenate([
        np.linalg.svd(_im2col_distinct(im, 5), compute_uv=False) for im in pyr
    ])
    return f1, f2, f3


# --------------------------- forest + scoring -------------------------------


def random_forest_predict(feat: np.ndarray, ldau: np.ndarray, rdau: np.ndarray,
                          threshold: np.ndarray, pred: np.ndarray,
                          best_attri: np.ndarray) -> float:
    """Mean prediction of an ensemble of decision trees (nrqm.py:1859-1894).

    All arrays are (node, tree), MATLAB 1-based child/attribute indices with
    0 = leaf, exactly as stored in NRQM_model.mat.
    """
    node_num, tree_num = ldau.shape
    k = np.zeros(tree_num, dtype=np.int64)
    done = np.zeros(tree_num, dtype=bool)
    out = np.zeros(tree_num)
    t = np.arange(tree_num)
    for _ in range(node_num):
        col = best_attri[k, t] - 1
        go_left = feat[col] <= threshold[k, t]
        nxt = np.where(go_left, ldau[k, t], rdau[k, t]) - 1
        leaf = (nxt == -1) & ~done
        out[leaf] = pred[k[leaf], t[leaf]]
        done |= leaf
        k = np.where(done, k, nxt)
        if done.all():
            break
    out[~done] = pred[k[~done], t[~done]]
    return float(out.mean())


def _load_model(path: str):
    import scipy.io
    params = scipy.io.loadmat(path)["model"]
    linear = np.asarray(params["linear"][0, 0], np.float64).reshape(-1)
    forests = []
    for i in range(3):
        p = params["rf"][0, 0][0, i][0, 0]
        forests.append(tuple(np.asarray(p[j]) for j in (0, 1, 4, 5, 6)))
    return linear, forests


def calculate_nrqm(img: np.ndarray, model_path: str,
                   crop_border: int = 0) -> float:
    """NRQM score of a grayscale/Y image in [0, 255] (HxW float array).

    ``model_path``: released ``NRQM_model.mat`` (see module docstring).
    """
    if not os.path.exists(model_path):
        raise FileNotFoundError(
            f"NRQM_model.mat not found at {model_path}; download the released "
            "model (IQA-PyTorch v0.1-weights) to compute NRQM scores.")
    linear, forests = _load_model(model_path)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    feats = nrqm_features(img)
    preds = np.array([1.0] + [
        random_forest_predict(f, *rf) for f, rf in zip(feats, forests)
    ])
    return float(preds @ linear)


def calculate_pi(img: np.ndarray, nrqm_model_path: str, niqe_params_path: str,
                 crop_border: int = 4) -> float:
    """Perceptual Index = 0.5 * ((10 - NRQM) + NIQE) (nrqm.py:2006-2034)."""
    nrqm = calculate_nrqm(img, nrqm_model_path, crop_border)
    niqe = calculate_niqe(img, niqe_params_path, crop_border=crop_border,
                          convert_to=None)
    return 0.5 * ((10.0 - nrqm) + niqe)
