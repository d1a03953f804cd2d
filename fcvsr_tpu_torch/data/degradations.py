"""Random degradations that make RealBasicVSR's training LQ from its GT (the
port's own copy of ``fcvsr_tpu.data.degradations``; numpy, scipy and PIL).

mmedit's datasets/pipelines/{blur_kernels.py, random_degradations.py}:

* blur kernels: bivariate (generalised) Gaussian, plateau and circular
  sinc, with random parameters;
* ``RandomBlur``, ``RandomResize``, ``RandomNoise``,
  ``RandomJPEGCompression`` and ``DegradationsWithShuffle``: the
  second-order chain of :func:`realbasicvsr_degradation_chain`;
* ``RandomVideoCompression`` needs the ``av`` codec library, as the
  reference does, and raises a clear error without it.

cv2's calls are written out: ``filter2D`` as a correlation with a
reflect-101 border, ``resize`` as separable half-pixel resizes (bilinear,
bicubic a = -0.75, area), JPEG as a PIL round trip.

Every draw comes from generators the caller passes: an
``np.random.RandomState`` (``rs``) for numpy's draws and a
``random.Random`` (``py_rng``) for the kernel size, where the JAX package
draws from the global ``np.random`` and ``random`` streams.  A
``RandomState(s)`` draws what ``np.random.seed(s)`` then ``np.random.*``
draws, so the two packages' chains agree bit for bit under matched seeds.
"""

from __future__ import annotations

import functools
import io
import random
from typing import Optional

import numpy as np
from numpy.lib.stride_tricks import as_strided

__all__ = [
    "bivariate_gaussian", "bivariate_generalized_gaussian",
    "bivariate_plateau", "random_circular_lowpass_kernel",
    "random_mixed_kernels", "filter2d", "resize_image",
    "RandomBlur", "RandomResize", "RandomNoise", "RandomJPEGCompression",
    "RandomVideoCompression", "DegradationsWithShuffle",
    "realbasicvsr_degradation_chain", "degrade_sequence",
]


# --------------------------- kernel generation -------------------------------


def _mesh_grid(kernel_size: int):
    r = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    x, y = np.meshgrid(r, r)
    return np.stack([x, y], axis=-1), x, y


def _sigma_matrix(sig_x, sig_y, theta, is_isotropic):
    if is_isotropic:
        return np.array([[sig_x ** 2, 0], [0, sig_x ** 2]], np.float32)
    diag = np.array([[sig_x ** 2, 0], [0, sig_y ** 2]], np.float32)
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]], np.float32)
    return rot @ diag @ rot.T


def _quadratic_form(kernel_size, sig_x, sig_y, theta, grid, is_isotropic):
    if grid is None:
        grid, _, _ = _mesh_grid(kernel_size)
    inv = np.linalg.inv(_sigma_matrix(sig_x, sig_y, theta, is_isotropic))
    return np.sum((grid @ inv) * grid, 2)


def bivariate_gaussian(kernel_size, sig_x, sig_y=None, theta=None,
                       grid=None, is_isotropic=True):
    """Normalised bivariate Gaussian kernel."""
    k = np.exp(-0.5 * _quadratic_form(kernel_size, sig_x, sig_y, theta, grid,
                                      is_isotropic))
    return k / k.sum()


def bivariate_generalized_gaussian(kernel_size, sig_x, sig_y=None, theta=None,
                                   beta=1.0, grid=None, is_isotropic=True):
    """exp(-0.5 (x^T S^-1 x)^beta), normalised."""
    k = np.exp(-0.5 * np.power(_quadratic_form(
        kernel_size, sig_x, sig_y, theta, grid, is_isotropic), beta))
    return k / k.sum()


def bivariate_plateau(kernel_size, sig_x, sig_y=None, theta=None, beta=1.0,
                      grid=None, is_isotropic=True):
    """1 / ((x^T S^-1 x)^beta + 1), normalised."""
    k = np.reciprocal(np.power(_quadratic_form(
        kernel_size, sig_x, sig_y, theta, grid, is_isotropic), beta) + 1)
    return k / k.sum()


def random_circular_lowpass_kernel(rs: np.random.RandomState, omega_range,
                                   kernel_size, pad_to=0):
    """2-D circular sinc filter with a cutoff drawn from ``omega_range``."""
    from scipy import special

    assert kernel_size % 2 == 1, "Kernel size must be an odd number."
    omega = rs.uniform(omega_range[0], omega_range[-1])
    with np.errstate(divide="ignore", invalid="ignore"):
        kernel = np.fromfunction(
            lambda x, y: omega * special.j1(omega * np.sqrt(
                (x - (kernel_size - 1) / 2) ** 2
                + (y - (kernel_size - 1) / 2) ** 2))
            / (2 * np.pi * np.sqrt((x - (kernel_size - 1) / 2) ** 2
                                   + (y - (kernel_size - 1) / 2) ** 2)),
            [kernel_size, kernel_size])
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = \
        omega ** 2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        p = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((p, p), (p, p)))
    return kernel


def random_mixed_kernels(rs: np.random.RandomState, kernel_list, kernel_prob,
                         kernel_size, sigma_x_range=(0.6, 5),
                         sigma_y_range=(0.6, 5),
                         rotation_range=(-np.pi, np.pi),
                         beta_gaussian_range=(0.5, 8),
                         beta_plateau_range=(1, 2),
                         omega_range=(0, np.pi), noise_range=None):
    """One kernel of a type drawn from ``kernel_list``, its parameters drawn
    from the ranges, optionally times multiplicative noise."""
    kernel_type = rs.choice(kernel_list, p=kernel_prob)
    sig_x = rs.uniform(*sigma_x_range)
    sig_y = rs.uniform(*sigma_y_range)
    theta = rs.uniform(*rotation_range)

    if kernel_type in ("iso", "aniso"):
        k = bivariate_gaussian(kernel_size, sig_x, sig_y, theta,
                               is_isotropic=kernel_type == "iso")
    elif kernel_type in ("generalized_iso", "generalized_aniso"):
        beta = rs.uniform(*beta_gaussian_range)
        k = bivariate_generalized_gaussian(
            kernel_size, sig_x, sig_y, theta, beta,
            is_isotropic=kernel_type == "generalized_iso")
    elif kernel_type in ("plateau_iso", "plateau_aniso"):
        beta = rs.uniform(*beta_plateau_range)
        k = bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta,
                              is_isotropic=kernel_type == "plateau_iso")
    elif kernel_type == "sinc":
        return random_circular_lowpass_kernel(rs, omega_range, kernel_size)
    else:
        raise NotImplementedError(f"kernel type {kernel_type}")
    if noise_range is not None:
        k = k * rs.uniform(noise_range[0], noise_range[1], size=k.shape)
        k = k / k.sum()
    return k


# ------------------------------ image ops ------------------------------------


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D: correlation with a reflect-101 border, (H, W[, C])."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    pad = np.pad(img, ((ph, kh - 1 - ph), (pw, kw - 1 - pw), (0, 0)),
                 mode="reflect")
    h, w, c = img.shape
    s0, s1, s2 = pad.strides
    win = as_strided(pad, (h, w, kh, kw, c), (s0, s1, s0, s1, s2))
    out = np.einsum("hwijc,ij->hwc", win, kernel).astype(img.dtype, copy=False)
    return out[..., 0] if squeeze else out


def _cubic_w(t):
    a = -0.75
    at = np.abs(t)
    return np.where(at <= 1, (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1,
                    np.where(at < 2, a * (at ** 3 - 5 * at ** 2 + 8 * at - 4),
                             0.0))


def _lanczos_w(t, a=4):
    at = np.abs(t)
    with np.errstate(invalid="ignore"):
        w = np.sinc(t) * np.sinc(t / a)
    return np.where(at < a, w, 0.0)


@functools.lru_cache(maxsize=None)
def _resize_weights(in_len: int, out_len: int, kind: str):
    """A dense (out, in) box matrix for a shrinking 'area' resize, else
    (weights (out, taps), source indices (out, taps)) at half-pixel
    positions, clamped at the edges."""
    scale = out_len / in_len
    if kind == "area" and scale < 1:
        inv = in_len / out_len
        w = np.zeros((out_len, in_len))
        for o in range(out_len):
            lo, hi = o * inv, (o + 1) * inv
            # float rounding can put ceil(hi) one past in_len
            for i in range(max(int(np.floor(lo)), 0),
                           min(int(np.ceil(hi)), in_len)):
                w[o, i] = min(hi, i + 1) - max(lo, i)
        return (w / w.sum(1, keepdims=True)).astype(np.float32)
    src = (np.arange(out_len) + 0.5) / scale - 0.5
    if kind == "bilinear" or (kind == "area" and scale >= 1):
        support, fn = 1, lambda t: np.maximum(0, 1 - np.abs(t))
    elif kind == "bicubic":
        support, fn = 2, _cubic_w
    elif kind == "lanczos":
        support, fn = 4, _lanczos_w
    else:
        raise NotImplementedError(kind)
    idx = np.floor(src)[:, None] + np.arange(-support + 1, support + 1)[None]
    wgt = fn(src[:, None] - idx)
    wgt = wgt / wgt.sum(1, keepdims=True)
    idx = np.clip(idx, 0, in_len - 1).astype(np.int64)
    return wgt.astype(np.float32), idx


def _resize_axis(x: np.ndarray, out_len: int, axis: int, kind: str):
    ws = _resize_weights(x.shape[axis], out_len, kind)
    if isinstance(ws, tuple):
        wgt, idx = ws
        taken = np.take(x, idx, axis=axis)          # (..., out, taps, ...)
        letters = "abcdefg"
        rest = letters[axis: x.ndim - 1]
        spec = f"{letters[:axis]}ot{rest},ot->{letters[:axis]}o{rest}"
        return np.einsum(spec, taken, wgt).astype(np.float32)
    out = np.tensordot(ws, x, axes=([1], [axis]))
    return out if axis == 0 else np.moveaxis(out, 0, axis)


def resize_image(img: np.ndarray, target_hw: tuple, kind: str) -> np.ndarray:
    """Separable resize of an (H, W, C) float image with cv2.resize's
    conventions: half-pixel centres, clamped edges, no antialiasing but
    'area''s box when it shrinks."""
    oh, ow = target_hw
    if img.shape[:2] == (oh, ow):
        return img
    return _resize_axis(_resize_axis(img, oh, 0, kind), ow, 1, kind)


def _jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """float [0, 1] (H, W, 3) through a PIL (libjpeg) encode and decode."""
    from PIL import Image

    u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, format="JPEG", quality=int(quality))
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"), np.float32) / 255.0


# ------------------------------ transforms -----------------------------------


class _Transform:
    """A degradation of ``results[key]`` for each key: one image or a list
    of frames, whose parameters drift from frame to frame.  ``__call__``
    takes the generators of the draws."""

    def __init__(self, params, keys):
        self.params = params
        self.keys = keys

    def apply(self, imgs, rs, py_rng):
        raise NotImplementedError

    def __call__(self, results, rs: np.random.RandomState,
                 py_rng: random.Random):
        for key in self.keys:
            imgs = results[key]
            single = isinstance(imgs, np.ndarray)
            out = self.apply([imgs] if single else imgs, rs, py_rng)
            results[key] = out[0] if single else out
        return results


class RandomBlur(_Transform):
    """A blur kernel a frame, its type and size fixed over the frames and
    its parameters drifting by their ``*_step``."""

    def get_kernel(self, num_kernels, rs, py_rng):
        p = self.params
        kernel_type = rs.choice(p["kernel_list"], p=p["kernel_prob"])
        kernel_size = py_rng.choice(p["kernel_size"])
        ranges = {
            "sigma_x": p.get("sigma_x", [0, 0]),
            "sigma_y": p.get("sigma_y", [0, 0]),
            "rotate_angle": p.get("rotate_angle", [-np.pi, np.pi]),
            "beta_gaussian": p.get("beta_gaussian", [0.5, 4]),
            "beta_plateau": p.get("beta_plateau", [1, 2])}
        value = {k: rs.uniform(*r) for k, r in ranges.items()}
        omega_range = p.get("omega")
        if omega_range is None:
            omega_range = [np.pi / 3, np.pi] if kernel_size < 13 \
                else [np.pi / 5, np.pi]
        ranges["omega"] = omega_range
        value["omega"] = rs.uniform(*omega_range)
        kernels = []
        for _ in range(num_kernels):
            v = value
            kernels.append(random_mixed_kernels(
                rs, [kernel_type], [1], kernel_size,
                [v["sigma_x"]] * 2, [v["sigma_y"]] * 2,
                [v["rotate_angle"]] * 2, [v["beta_gaussian"]] * 2,
                [v["beta_plateau"]] * 2, [v["omega"]] * 2, None))
            for k, r in ranges.items():
                step = p.get(f"{k}_step", 0)
                value[k] = np.clip(value[k] + rs.uniform(-step, step), *r)
        return kernels

    def __call__(self, results, rs, py_rng):
        if rs.uniform() > self.params.get("prob", 1):
            return results
        return super().__call__(results, rs, py_rng)

    def apply(self, imgs, rs, py_rng):
        kernels = self.get_kernel(len(imgs), rs, py_rng)
        return [filter2d(img, k) for img, k in zip(imgs, kernels)]


class RandomResize(_Transform):
    """A resize to a drawn scale (up, down or kept) with a drawn kind,
    the scale drifting by ``resize_step`` from frame to frame."""

    def __call__(self, results, rs, py_rng):
        if rs.uniform() > self.params.get("prob", 1):
            return results
        return super().__call__(results, rs, py_rng)

    def _size(self, h, w, scale_factor):
        h_out, w_out = h * scale_factor, w * scale_factor
        if self.params.get("is_size_even", False):
            h_out, w_out = 2 * (h_out // 2), 2 * (w_out // 2)
        return int(h_out), int(w_out)

    def apply(self, imgs, rs, py_rng):
        p = self.params
        h, w = imgs[0].shape[:2]
        kind = rs.choice(p["resize_opt"], p=p["resize_prob"]).lower()
        resize_step = p.get("resize_step", 0)
        target_size = p.get("target_size")
        scale_factor = 1.0
        if target_size is None:
            mode = rs.choice(["up", "down", "keep"], p=p["resize_mode_prob"])
            scale = p["resize_scale"]
            if mode == "up":
                scale_factor = rs.uniform(1, scale[1])
            elif mode == "down":
                scale_factor = rs.uniform(scale[0], 1)
            target_size = self._size(h, w, scale_factor)
        else:
            resize_step = 0
        outputs = []
        for img in imgs:
            outputs.append(resize_image(img, target_size, kind))
            if resize_step:
                scale_factor = np.clip(
                    scale_factor + rs.uniform(-resize_step, resize_step),
                    *p["resize_scale"])
                target_size = self._size(h, w, scale_factor)
        return outputs


class RandomNoise(_Transform):
    """Gaussian or Poisson noise (colour or grey), its strength drifting
    from frame to frame."""

    def __call__(self, results, rs, py_rng):
        p = self.params
        if rs.uniform() > p.get("prob", 1):
            return results
        self._type = rs.choice(p["noise_type"], p=p["noise_prob"]).lower()
        return super().__call__(results, rs, py_rng)

    def apply(self, imgs, rs, py_rng):
        return self._gaussian(imgs, rs) if self._type == "gaussian" \
            else self._poisson(imgs, rs)

    def _gaussian(self, imgs, rs):
        p = self.params
        sigma_range = p["gaussian_sigma"]
        sigma = rs.uniform(*sigma_range) / 255.0
        step = p.get("gaussian_sigma_step", 0)
        gray = rs.uniform() < p["gaussian_gray_noise_prob"]
        out = []
        for img in imgs:
            noise = rs.randn(*img.shape).astype(np.float32) * sigma
            if gray:
                noise = noise[:, :, :1]
            out.append(img + noise)
            sigma = np.clip(sigma + rs.uniform(-step, step) / 255.0,
                            sigma_range[0] / 255.0, sigma_range[1] / 255.0)
        return out

    def _poisson(self, imgs, rs):
        p = self.params
        scale_range = p["poisson_scale"]
        scale = rs.uniform(*scale_range)
        step = p.get("poisson_scale_step", 0)
        gray = rs.uniform() < p["poisson_gray_noise_prob"]
        out = []
        for img in imgs:
            noise = img.copy()
            if gray:
                # cv2's BGR2GRAY on the RGB frame reversed: ITU-R 601 luma
                noise = (0.299 * noise[..., 0] + 0.587 * noise[..., 1]
                         + 0.114 * noise[..., 2])[..., None]
            noise = np.clip((noise * 255.0).round(), 0, 255) / 255.0
            unique = 2 ** np.ceil(np.log2(len(np.unique(noise))))
            noise = rs.poisson(noise * unique) / unique - noise
            out.append(img + noise * scale)
            scale = np.clip(scale + rs.uniform(-step, step), *scale_range)
        return out


class RandomJPEGCompression(_Transform):
    """A JPEG round trip at a drawn quality, drifting by ``quality_step``."""

    def __call__(self, results, rs, py_rng):
        p = self.params
        if rs.uniform() > p.get("prob", 1):
            return results
        self._q = round(rs.uniform(*p["quality"]))
        return super().__call__(results, rs, py_rng)

    def apply(self, imgs, rs, py_rng):
        p = self.params
        step = p.get("quality_step", 0)
        out = []
        for img in imgs:
            out.append(_jpeg_roundtrip(img, self._q))
            self._q = round(np.clip(self._q + rs.uniform(-step, step),
                                    *p["quality"]))
        return out


class RandomVideoCompression(_Transform):
    """A video codec round trip; needs the ``av`` library (PyAV), as the
    reference does, and raises a clear error without it."""

    def __init__(self, params, keys):
        super().__init__(params, keys)
        try:
            import av  # noqa: F401
            self._has_av = True
        except ImportError:
            self._has_av = False

    def __call__(self, results, rs, py_rng):
        if rs.uniform() > self.params.get("prob", 1):
            return results
        if not self._has_av:
            raise RuntimeError(
                "RandomVideoCompression requires the 'av' library (PyAV), "
                "which is not installed, as the reference does "
                "(random_degradations.py:14-17).")
        import av

        p = self.params
        codec = rs.choice(p["codec"], p=p["codec_prob"])
        bitrate = int(rs.randint(*p["bitrate"]))
        for key in self.keys:
            imgs = results[key]
            buf = io.BytesIO()
            with av.open(buf, "w", "mp4") as container:
                stream = container.add_stream(codec, rate=1)
                stream.height = imgs[0].shape[0]
                stream.width = imgs[0].shape[1]
                stream.pix_fmt = "yuv420p"
                stream.bit_rate = bitrate
                for img in imgs:
                    u8 = np.clip(img * 255, 0, 255).astype(np.uint8)
                    frame = av.VideoFrame.from_ndarray(u8, format="rgb24")
                    for packet in stream.encode(frame):
                        container.mux(packet)
                for packet in stream.encode():
                    container.mux(packet)
            out = []
            with av.open(buf, "r", "mp4") as container:
                for frame in container.decode(video=0):
                    out.append(frame.to_rgb().to_ndarray().astype(np.float32)
                               / 255.0)
            results[key] = out
        return results


_ALLOWED = {
    "RandomBlur": RandomBlur,
    "RandomResize": RandomResize,
    "RandomNoise": RandomNoise,
    "RandomJPEGCompression": RandomJPEGCompression,
    "RandomVideoCompression": RandomVideoCompression,
}


class DegradationsWithShuffle:
    """A chain of degradations, some of them (``shuffle_idx``) shuffled on
    every call; a list in the chain is a group applied in order.  The
    shuffle rearranges the chain in place, as the reference's does, so each
    call starts from the previous call's order.

    ``rs`` and ``py_rng`` are the chain's generators; a call may pass
    others."""

    def __init__(self, degradations, keys, shuffle_idx=None,
                 rs: Optional[np.random.RandomState] = None,
                 py_rng: Optional[random.Random] = None):
        self.keys = keys
        self.degradations = self._build(list(degradations))
        self.shuffle_idx = list(range(len(self.degradations))) \
            if shuffle_idx is None else list(shuffle_idx)
        self.rs = rs if rs is not None else np.random.RandomState(0)
        self.py_rng = py_rng if py_rng is not None else random.Random(0)

    def _build(self, degradations):
        built = []
        for d in degradations:
            if isinstance(d, (list, tuple)):
                built.append(self._build(list(d)))
            else:
                built.append(_ALLOWED[d["type"]](d["params"], self.keys))
        return built

    def __call__(self, results, rs: Optional[np.random.RandomState] = None,
                 py_rng: Optional[random.Random] = None):
        rs = self.rs if rs is None else rs
        py_rng = self.py_rng if py_rng is None else py_rng
        if self.shuffle_idx:
            group = [self.degradations[i] for i in self.shuffle_idx]
            rs.shuffle(group)
            for i, idx in enumerate(self.shuffle_idx):
                self.degradations[idx] = group[i]
        for d in self.degradations:
            for sub in (d if isinstance(d, list) else [d]):
                results = sub(results, rs, py_rng)
        return results


_BLUR_KERNELS = {
    "kernel_size": [7, 9, 11, 13, 15, 17, 19, 21],
    "kernel_list": ["iso", "aniso", "generalized_iso", "generalized_aniso",
                    "plateau_iso", "plateau_aniso", "sinc"],
    "kernel_prob": [0.405, 0.225, 0.108, 0.027, 0.108, 0.027, 0.1],
    "rotate_angle": [-3.1416, 3.1416],
    "beta_gaussian": [0.5, 4], "beta_plateau": [1, 2]}
_RESIZE_KINDS = {"resize_opt": ["bilinear", "area", "bicubic"],
                 "resize_prob": [1 / 3.0, 1 / 3.0, 1 / 3.0]}
_NOISE_TYPES = {"noise_type": ["gaussian", "poisson"],
                "noise_prob": [0.5, 0.5]}


def realbasicvsr_degradation_chain(
        keys=("lq",), include_video_compression: bool = False,
        rs: Optional[np.random.RandomState] = None,
        py_rng: Optional[random.Random] = None) -> DegradationsWithShuffle:
    """RealBasicVSR's second-order training degradation: blur, resize,
    noise and JPEG, then a lighter blur, resize and noise, then a group of
    [JPEG, video compression] (shuffled when the latter is included; it
    needs PyAV and is off by default).  ``rs`` and ``py_rng`` are its
    generators (seed 0 when not given)."""
    first = [
        {"type": "RandomBlur", "params": dict(
            _BLUR_KERNELS, sigma_x=[0.2, 3], sigma_y=[0.2, 3],
            sigma_x_step=0.02, sigma_y_step=0.02, rotate_angle_step=0.31416,
            beta_gaussian_step=0.05, beta_plateau_step=0.1,
            omega_step=0.0628)},
        {"type": "RandomResize", "params": dict(
            _RESIZE_KINDS, resize_mode_prob=[0.2, 0.7, 0.1],  # up, down, keep
            resize_scale=[0.15, 1.5], resize_step=0.015, is_size_even=True)},
        {"type": "RandomNoise", "params": dict(
            _NOISE_TYPES, gaussian_sigma=[1, 30], gaussian_gray_noise_prob=0.4,
            poisson_scale=[0.05, 3], poisson_gray_noise_prob=0.4,
            gaussian_sigma_step=0.1, poisson_scale_step=0.005)},
        {"type": "RandomJPEGCompression", "params": {
            "quality": [30, 95], "quality_step": 3}},
    ]
    second = [
        {"type": "RandomBlur", "params": dict(
            _BLUR_KERNELS, prob=0.8, sigma_x=[0.2, 1.5], sigma_y=[0.2, 1.5],
            sigma_x_step=0.005, sigma_y_step=0.005,
            rotate_angle_step=0.31416, beta_gaussian_step=0.02,
            beta_plateau_step=0.05, omega_step=0.0628)},
        {"type": "RandomResize", "params": dict(
            _RESIZE_KINDS, resize_mode_prob=[0.3, 0.4, 0.3],
            resize_scale=[0.3, 1.2], resize_step=0.03, is_size_even=True)},
        {"type": "RandomNoise", "params": dict(
            _NOISE_TYPES, gaussian_sigma=[1, 25], gaussian_gray_noise_prob=0.4,
            poisson_scale=[0.05, 2.5], poisson_gray_noise_prob=0.4,
            gaussian_sigma_step=0.1, poisson_scale_step=0.005)},
    ]
    tail = [{"type": "RandomJPEGCompression",
             "params": {"quality": [30, 95], "quality_step": 3}}]
    if include_video_compression:
        tail.append({"type": "RandomVideoCompression", "params": {
            "codec": ["libx264", "h264", "mpeg4"],
            "codec_prob": [1 / 3.0, 1 / 3.0, 1 / 3.0],
            "bitrate": [1e4, 1e5]}})
    chain = first + second + [tail]
    shuffle_idx = [len(chain) - 1] if include_video_compression else []
    return DegradationsWithShuffle(chain, list(keys), shuffle_idx, rs, py_rng)


def degrade_sequence(chain: DegradationsWithShuffle, gt_frames: np.ndarray,
                     scale: int = 4,
                     rs: Optional[np.random.RandomState] = None,
                     py_rng: Optional[random.Random] = None) -> np.ndarray:
    """The chain applied to a GT sequence (T, H, W, C) float32 in [0, 1],
    then each frame clipped and resized (bicubic) to the LQ grid
    (H / scale, W / scale): (T, H / scale, W / scale, C) float32 in
    [0, 1].  ``rs`` and ``py_rng`` default to the chain's."""
    t, h, w, _ = gt_frames.shape
    results = chain({"lq": [gt_frames[i] for i in range(t)]}, rs, py_rng)
    out = []
    for img in results["lq"]:
        img = resize_image(np.clip(img, 0, 1), (h // scale, w // scale),
                           "bicubic")
        out.append(np.clip(img, 0, 1).astype(np.float32))
    return np.stack(out)
