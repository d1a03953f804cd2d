"""Flow and feature-map pictures, host-side numpy (counterpart of
``fcvsr_tpu.utils.visualize``, after the reference's CVSR_freq.py:41-221):
``make_colorwheel`` and ``flow_to_image``, the Baker et al. optical-flow
colour coding; ``featuremap_visual``, a feature map's channel mean as a
grey picture; ``save_comparison``, a [bicubic | SR | GT] strip as a PNG.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_colorwheel", "flow_to_image", "featuremap_visual",
           "save_comparison"]


def make_colorwheel() -> np.ndarray:
    """(55, 3) RGB colour wheel (RY/YG/GC/CB/BM/MR segments)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray, clip_flow: float | None = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 colour coding."""
    u = np.asarray(flow[..., 0], np.float64)
    v = np.asarray(flow[..., 1], np.float64)
    if clip_flow is not None:
        u = np.clip(u, 0, clip_flow)
        v = np.clip(v, 0, clip_flow)
    rad = np.sqrt(u ** 2 + v ** 2)
    rad_max = max(rad.max(), 1e-5)
    u = u / rad_max
    v = v / rad_max
    rad = rad / rad_max

    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(u.shape + (3,), np.uint8)
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        col = 1 - rad * (1 - col)  # saturate with radius
        ch = 2 - i if convert_to_bgr else i
        img[..., ch] = np.floor(255 * col)
    return img


def featuremap_visual(feat, num_ch: int | None = None,
                      layout: str = "nchw") -> np.ndarray:
    """(B, C, H, W) (default, like the reference) or (B, H, W, C) features,
    an array or a tensor on any device -> (H, W, 1) gray rendering of the
    channel mean, scaled to [0, 255]."""
    if hasattr(feat, "detach"):
        feat = feat.detach().float().cpu().numpy()
    arr = np.asarray(feat)
    if arr.ndim == 4:
        arr = arr[0]
        if layout == "nchw":
            arr = np.transpose(arr, (1, 2, 0))
    if num_ch:
        arr = arr[..., : num_ch]
    m = arr.mean(-1)
    lo, hi = m.min(), m.max()
    scale = 255.0 / (hi - lo) if hi > lo else 1.0
    return ((m - lo) * scale)[..., None].astype(np.float64)


def save_comparison(path: str, lr_up: np.ndarray, sr: np.ndarray,
                    gt: np.ndarray | None = None) -> None:
    """Side-by-side [bicubic | SR | GT] PNG (mmedit's VisualizationHook,
    core/hooks/visualization.py).  Inputs are (H, W, C) floats in
    [0, 255]."""
    from PIL import Image

    panels = [lr_up, sr] + ([gt] if gt is not None else [])
    strip = np.concatenate([np.clip(p, 0, 255) for p in panels], axis=1)
    arr = strip.astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)
