"""The port's ops (fcvsr_tpu_torch.ops) against the JAX ops, on the CPU.

Inputs come from numpy seeds and go to both packages.  Tolerances: 1e-5 abs
for f32 ops that do the same arithmetic in another framework (gathers,
shifted multiply-adds, resizes); 1e-4 for FFT-based ops, where pocketfft
and XLA's FFT sum in other orders over up to H*W terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models.blocks import pixel_shuffle as j_pixel_shuffle
from fcvsr_tpu.ops import corr as j_corr
from fcvsr_tpu.ops import freq as j_freq
from fcvsr_tpu.ops import resize as j_resize
from fcvsr_tpu.ops import warp as j_warp
from fcvsr_tpu.ops.sac import sac as j_sac
from fcvsr_tpu_torch.models.blocks import pixel_shuffle
from fcvsr_tpu_torch.ops import corr, freq, resize, warp
from fcvsr_tpu_torch.ops.sac import sac

ATOL = 1e-5
FFT_ATOL = 1e-4


def _pair(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got, ref, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("scale", [0.7, 6.0, 40.0])
def test_flow_warp_matches_jax(scale):
    """Small, large and mostly out-of-frame flows."""
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 9, 11, 5)))
    fj, ft = _pair(rng.standard_normal((2, 9, 11, 2)) * scale)
    _close(warp.flow_warp(xt, ft), j_warp.flow_warp(xj, fj), ATOL)


def test_grid_sample_bilinear_matches_jax():
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((1, 7, 8, 3)))
    pxj, pxt = _pair(rng.uniform(-3, 11, (1, 40)))
    pyj, pyt = _pair(rng.uniform(-3, 10, (1, 40)))
    _close(warp.grid_sample_bilinear(xt, pxt, pyt),
           j_warp.grid_sample_bilinear(xj, pxj, pyj), ATOL)


@pytest.mark.parametrize("tap_major,kernel1_both",
                         [(False, True), (True, True), (False, False)])
def test_sac_matches_jax(tap_major, kernel1_both):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((2, 7, 10, 4)))
    k1j, k1t = _pair(rng.standard_normal((2, 7, 10, 12)))
    k2j, k2t = _pair(rng.standard_normal((2, 7, 10, 12)))
    _close(sac(xt, k1t, k2t, 3, kernel1_both, tap_major),
           j_sac(xj, k1j, k2j, 3, kernel1_both, tap_major), ATOL)


@pytest.mark.parametrize("shape", [(1, 16, 16, 128), (2, 40, 9, 16)])
def test_corr_lookup_matches_jax(shape):
    """The memory-reinterpret lookup, with the corner clipped by H and W."""
    rng = np.random.default_rng(3)
    aj, at = _pair(rng.standard_normal(shape))
    bj, bt = _pair(rng.standard_normal(shape))
    _close(corr.corr_lookup(at, bt), j_corr.corr_lookup(aj, bj), ATOL)


@pytest.mark.parametrize("groups", [1, 3])
def test_rfft_irfft_features_match_jax(groups):
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal((1, 12, 10, 6)))
    ref = j_freq.rfft_features(xj, groups=groups)
    _close(freq.rfft_features(xt, groups=groups), ref, FFT_ATOL)
    pj, pt = _pair(np.asarray(ref))
    _close(freq.irfft_features(pt, 12, 10),
           j_freq.irfft_features(pj, 12, 10), FFT_ATOL)


def test_gaussian_band_masks_match_jax():
    """The 1024-grid masks resized with torch bicubic against the JAX
    weight-matrix bicubic (f32 coordinates, like torch's CPU kernel)."""
    shifted, centered = freq.gaussian_band_masks(4, 16, 24)
    j_shifted, j_centered = j_freq.gaussian_band_masks(4, 16, 24)
    _close(centered, j_centered, ATOL)
    _close(shifted, j_shifted, ATOL)


def test_split_freq_matches_jax():
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng.standard_normal((2, 16, 12, 3)))
    _close(freq.split_freq(xt, 4), j_freq.split_freq(xj, 4), FFT_ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 12, 5), (1, 7, 9, 3)])
def test_resizes_match_jax(shape):
    """x4 base path, and the x2 / x0.5 exchange, odd sizes included."""
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng.standard_normal(shape))
    h, w = shape[1:3]
    _close(resize.resize_bilinear(xt, 4 * h, 4 * w),
           j_resize.resize_bilinear(xj, 4 * h, 4 * w), ATOL)
    _close(resize.upsample2x_bilinear(xt), j_resize.upsample2x_bilinear(xj),
           ATOL)
    _close(resize.downsample2x_bilinear(xt),
           j_resize.downsample2x_bilinear(xj), ATOL)


def test_pixel_shuffle_matches_jax():
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng.standard_normal((2, 3, 5, 16)))
    _close(pixel_shuffle(xt), j_pixel_shuffle(xj), 0.0)
