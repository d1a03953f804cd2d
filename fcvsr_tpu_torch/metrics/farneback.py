"""Farnebäck dense optical flow in pure numpy, for the tOF metric (the
port's own copy of ``fcvsr_tpu.metrics.farneback``).

The reference computes tOF with ``cv2.calcOpticalFlowFarneback(prev, next,
None, 0.5, 3, 15, 3, 5, 1.2, 0)`` (mmedit core/evaluation/metrics.py:363-367,
CVSR_train/metric/psnr_ssim.py:404).  The port is held to the JAX package,
which computes it with its own numpy Farnebäck, so this module
re-implements the algorithm too, without OpenCV (Farnebäck 2003,
"Two-frame motion estimation based on polynomial expansion") following
OpenCV's structure: Gaussian-smoothed linear pyramid, per-level polynomial
expansion, iterative displacement refinement with box-blurred normal
equations.

Numerical caveat: out-of-image warp handling deviates from OpenCV at
frame borders.  Against ``cv2.calcOpticalFlowFarneback`` with the
reference's arguments, tOF stays within 15% on small frames (64x96 and
58x90, where the borders weigh most; tests/test_torch_config_tof.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["farneback_flow", "calculate_tof"]


def _gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        sigma = 0.3 * ((n - 1) * 0.5 - 1) + 0.8
    i = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    k = np.exp(-(i ** 2) / (2 * sigma * sigma))
    return k / k.sum()


def _sep_filter_reflect101(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable correlation with reflect-101 borders (OpenCV default)."""
    r = len(k) // 2
    p = np.pad(img, ((r, r), (r, r)), mode="reflect")
    out = np.zeros_like(p, dtype=np.float64)
    for t in range(len(k)):
        out[: img.shape[0] + 2 * r, :] += 0  # keep shape clarity
    # rows
    tmp = np.zeros((img.shape[0], p.shape[1]), np.float64)
    for t in range(len(k)):
        tmp += k[t] * p[t : t + img.shape[0], :]
    res = np.zeros(img.shape, np.float64)
    for t in range(len(k)):
        res += k[t] * tmp[:, t : t + img.shape[1]]
    return res


def _resize_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """Half-pixel bilinear resize of one axis, as
    ``F.interpolate(mode='bilinear', align_corners=False)`` computes it
    with ``size=``: src = (dst + 0.5) * in / out - 0.5, clamped; each
    output the two-tap sum of its neighbours, the weights rounded to
    float32 (the JAX package's copy builds the same weights into dense
    float32 matrices, O(N^2) a row where this is O(1))."""
    in_size = img.shape[axis]
    if in_size == out_size:
        return img
    if in_size == 1:
        return np.repeat(img, out_size, axis)
    scale = in_size / out_size
    src = np.clip((np.arange(out_size) + 0.5) * scale - 0.5, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    shape = [1] * img.ndim
    shape[axis] = out_size
    w_lo = (1.0 - frac).astype(np.float32).astype(np.float64).reshape(shape)
    w_hi = frac.astype(np.float32).astype(np.float64).reshape(shape)
    return np.take(img, lo, axis) * w_lo + np.take(img, hi, axis) * w_hi


def _resize_bilinear_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel bilinear resize (OpenCV INTER_LINEAR convention)."""
    return _resize_axis(_resize_axis(np.asarray(img, np.float64), out_h, 0),
                        out_w, 1)


def _poly_exp(img: np.ndarray, n: int, sigma: float):
    """Polynomial expansion: per-pixel coeffs (b_y, b_x, a_yy, a_xx, a_xy).

    Follows OpenCV FarnebackPolyExp: separable weighted moment accumulation
    with replicate borders, solved through the precomputed inverse Gram
    matrix of the basis {1, x, y, x^2, y^2, xy}.
    """
    h, w = img.shape
    i = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(i ** 2) / (2 * sigma * sigma))
    g /= g.sum()
    xg = i * g
    xxg = i * i * g

    # Inverse Gram of the 6-basis under the separable weight g(x)g(y).
    xx, yy = np.meshgrid(i, i)
    wgt = np.outer(g, g).ravel()
    basis = np.stack(
        [np.ones_like(xx).ravel(), xx.ravel(), yy.ravel(),
         (xx ** 2).ravel(), (yy ** 2).ravel(), (xx * yy).ravel()], axis=1)
    G = basis.T @ (basis * wgt[:, None])
    invG = np.linalg.inv(G)
    ig11, ig03, ig33, ig55 = invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]

    pad = np.pad(img.astype(np.float64), n, mode="edge")

    # vertical pass: b1 = sum g, b2 = sum xg (antisym), b3 = sum xxg
    b1 = np.zeros((h, w + 2 * n)); b2 = np.zeros_like(b1); b3 = np.zeros_like(b1)
    for t in range(2 * n + 1):
        rows = pad[t : t + h, :]
        b1 += g[t] * rows
        b2 += xg[t] * rows
        b3 += xxg[t] * rows

    # horizontal pass
    def hpass(src, k):
        out = np.zeros((h, w))
        for t in range(2 * n + 1):
            out += k[t] * src[:, t : t + w]
        return out

    s1 = hpass(b1, g)     # Σ g_x g_y I
    sx = hpass(b1, xg)    # Σ x
    sxx = hpass(b1, xxg)  # Σ x²
    sy = hpass(b2, g)     # Σ y
    sxy = hpass(b2, xg)   # Σ xy
    syy = hpass(b3, g)    # Σ y²

    R = np.empty((h, w, 5))
    R[..., 0] = ig11 * sy             # b_y
    R[..., 1] = ig11 * sx             # b_x
    R[..., 2] = ig03 * s1 + ig33 * syy  # a_yy
    R[..., 3] = ig03 * s1 + ig33 * sxx  # a_xx
    R[..., 4] = ig55 * sxy              # a_xy
    return R


def _update_matrices(R0, R1, flow):
    """Per-pixel normal-equation terms M = (G, h) for A d = Δb."""
    h, w = flow.shape[:2]
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fx = gx + flow[..., 0]
    fy = gy + flow[..., 1]
    x1 = np.floor(fx).astype(np.int64)
    y1 = np.floor(fy).astype(np.int64)
    tx = fx - x1
    ty = fy - y1
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    x1c = np.clip(x1, 0, w - 2)
    y1c = np.clip(y1, 0, h - 2)

    a00 = (1 - tx) * (1 - ty)
    a01 = tx * (1 - ty)
    a10 = (1 - tx) * ty
    a11 = tx * ty
    # the four corners, gathered from the flattened rows of R1
    r1 = R1.reshape(h * w, -1)
    i00 = y1c * w + x1c
    R1i = (
        a00[..., None] * np.take(r1, i00, 0)
        + a01[..., None] * np.take(r1, i00 + 1, 0)
        + a10[..., None] * np.take(r1, i00 + w, 0)
        + a11[..., None] * np.take(r1, i00 + w + 1, 0)
    )
    # outside the frame: no constraint from frame 1 — reuse frame-0 quadratic,
    # zero first-order difference (OpenCV-style fallback)
    R1i = np.where(inside[..., None], R1i,
                   np.concatenate([R0[..., :2] * 0, R0[..., 2:]], axis=-1))

    byy = (R0[..., 2] + R1i[..., 2]) * 0.5
    bxx = (R0[..., 3] + R1i[..., 3]) * 0.5
    bxy = (R0[..., 4] + R1i[..., 4]) * 0.25

    dby = (R0[..., 0] - R1i[..., 0]) * 0.5
    dbx = (R0[..., 1] - R1i[..., 1]) * 0.5
    dby = np.where(inside, dby, 0.0)
    dbx = np.where(inside, dbx, 0.0)
    dbx = dbx + bxx * flow[..., 0] + bxy * flow[..., 1]
    dby = dby + bxy * flow[..., 0] + byy * flow[..., 1]

    M = np.empty(flow.shape[:2] + (5,))
    M[..., 0] = bxx * bxx + bxy * bxy          # g11
    M[..., 1] = (bxx + byy) * bxy              # g12
    M[..., 2] = byy * byy + bxy * bxy          # g22
    M[..., 3] = bxx * dbx + bxy * dby          # h1
    M[..., 4] = bxy * dbx + byy * dby          # h2
    return M


def _box_blur(M: np.ndarray, winsize: int) -> np.ndarray:
    """Normalised box filter with replicate borders, per channel."""
    r = winsize // 2
    p = np.pad(M, ((r, r), (r, r), (0, 0)), mode="edge")
    c = np.cumsum(np.cumsum(p, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
    h, w = M.shape[:2]
    out = (
        c[winsize : winsize + h, winsize : winsize + w]
        - c[winsize : winsize + h, :w]
        - c[:h, winsize : winsize + w]
        + c[:h, :w]
    )
    return out / float(winsize * winsize)


def farneback_flow(
    prev: np.ndarray,
    curr: np.ndarray,
    pyr_scale: float = 0.5,
    levels: int = 3,
    winsize: int = 15,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.2,
) -> np.ndarray:
    """Dense flow prev->curr for single-channel [0,255] images, (H, W, 2)."""
    prev = np.asarray(prev, np.float64)
    curr = np.asarray(curr, np.float64)
    if prev.ndim == 3:
        prev = prev[..., 0]
        curr = curr[..., 0]
    h, w = prev.shape

    # cap levels so the coarsest image stays meaningful
    k = 0
    scale = 1.0
    for k in range(levels):
        scale *= pyr_scale if k > 0 else 1.0
    levels = max(1, levels)

    flow = None
    for lvl in range(levels - 1, -1, -1):
        scale = pyr_scale ** lvl
        lh, lw = int(round(h * scale)), int(round(w * scale))
        if min(lh, lw) < poly_n * 2 + 1:
            continue
        sigma_s = (1.0 / scale - 1.0) * 0.5
        ksz = max(int(round(sigma_s * 5)) | 1, 3)
        gk = _gaussian_kernel(ksz, sigma_s)
        i0 = _resize_bilinear_np(_sep_filter_reflect101(prev, gk), lh, lw)
        i1 = _resize_bilinear_np(_sep_filter_reflect101(curr, gk), lh, lw)

        if flow is None:
            flow = np.zeros((lh, lw, 2))
        else:
            flow = _resize_bilinear_np(flow, lh, lw) * (1.0 / pyr_scale)

        R0 = _poly_exp(i0, poly_n, poly_sigma)
        R1 = _poly_exp(i1, poly_n, poly_sigma)
        M = _update_matrices(R0, R1, flow)
        for it in range(iterations):
            Mb = _box_blur(M, winsize)
            g11, g12, g22 = Mb[..., 0], Mb[..., 1], Mb[..., 2]
            h1, h2 = Mb[..., 3], Mb[..., 4]
            det = g11 * g22 - g12 * g12
            det = np.where(np.abs(det) < 1e-9, 1e-9, det)
            flow = np.stack(
                [(g22 * h1 - g12 * h2) / det, (g11 * h2 - g12 * h1) / det],
                axis=-1,
            )
            if it < iterations - 1:
                M = _update_matrices(R0, R1, flow)
    if flow is None:
        flow = np.zeros((h, w, 2))
    return flow.astype(np.float32)


def calculate_tof(pred_cur, gt_cur, pred_pre, gt_pre, convert_to=None,
                  channel_order="bgr") -> float:
    """tOF: mean end-point error between GT flow and SR flow
    (mmedit metrics.py:312-372 semantics)."""
    from .psnr_ssim import bgr2y, rgb2y

    def prep(img):
        img = np.asarray(img, np.float32)
        if isinstance(convert_to, str) and convert_to.lower() == "y":
            conv = bgr2y if channel_order == "bgr" else rgb2y
            img = conv(img)
        elif img.ndim == 3:
            img = img[..., 0]
        return img

    gt_flow = farneback_flow(prep(gt_pre), prep(gt_cur))
    pred_flow = farneback_flow(prep(pred_pre), prep(pred_cur))
    diff = gt_flow - pred_flow
    return float(np.mean(np.sqrt(np.sum(diff ** 2, axis=-1))))
