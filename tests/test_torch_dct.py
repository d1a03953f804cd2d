"""The port's FTVSR ops (``fcvsr_tpu_torch.ops.dct`` and the nearest
warp) against the JAX ops, on the CPU.

Inputs come from numpy seeds, at odd shapes, and go to both packages.  Bar:
1e-5 max abs (the same f32 arithmetic in another framework); the index
ops (space-to-depth, the patch grid, the DCT pad, nearest sampling) equal
JAX's exactly.  The nearest warp gets coordinates that sit exactly on .5,
where half-to-even rounding (``torch.round``, ``jnp.round``) and
``floor(x + 0.5)`` part ways.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fcvsr_tpu.ops import dct as j_dct
from fcvsr_tpu.ops import warp as j_warp
from fcvsr_tpu_torch.ops import dct, warp

ATOL = 1e-5


def _pair(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got, ref, atol=ATOL):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _equal(got, ref):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_dct_basis_and_block_dct_match_jax():
    np.testing.assert_array_equal(dct.dct_basis(8).numpy(),
                                  j_dct.dct_basis(8))
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 16, 24, 3)))
    got = dct.block_dct(xt)
    _close(got, j_dct.block_dct(xj))
    # the reference layer: a stride-8 grouped conv with the cosine filters
    w = torch.cat([dct.dct_basis(8)[:, None]] * 3)
    ref = F.conv2d(xt.permute(0, 3, 1, 2), w, stride=8, groups=3)
    _close(got.permute(0, 3, 1, 2), ref.numpy())
    cj, ct = _pair(rng.standard_normal((2, 3, 5, 192)))
    _close(dct.block_idct(ct), j_dct.block_idct(cj))
    _close(dct.block_idct(got), xt.numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_space_to_depth_and_back_match_jax(k):
    rng = np.random.default_rng(k)
    xj, xt = _pair(rng.standard_normal((2, 3 * k, 5 * k, 7)))
    got = dct.space_to_depth(xt, k)
    _equal(got, j_dct.space_to_depth(xj, k))
    ref = F.unfold(xt.permute(0, 3, 1, 2), k, stride=k)
    _equal(got.reshape(2, -1, got.shape[-1]).permute(0, 2, 1), ref.numpy())
    _equal(dct.depth_to_space(got, k), xj)


@pytest.mark.parametrize("k,stride,pad", [(6, 4, 1), (8, 4, 2), (3, 2, 0)])
def test_patch_grid_matches_jax_and_unfold_fold(k, stride, pad):
    rng = np.random.default_rng(k)
    xj, xt = _pair(rng.standard_normal((2, 13, 18, 3)))
    got = dct.patch_grid(xt, k, stride, pad)
    _equal(got, j_dct.patch_grid(xj, k, stride, pad))
    nb_h, nb_w = (13 + 2 * pad - k) // stride + 1, (18 + 2 * pad - k) // \
        stride + 1
    ref = F.fold(F.unfold(xt.permute(0, 3, 1, 2), k, padding=pad,
                          stride=stride), (nb_h * k, nb_w * k), k, stride=k)
    _equal(got.permute(0, 3, 1, 2), ref.numpy())


@pytest.mark.parametrize("out", [(16, 10), (13, 18), (5, 3)])
def test_adaptive_avg_pool_matches_jax(out):
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal((2, 3, 26, 18, 5)))
    _close(dct.adaptive_avg_pool(xt, *out), j_dct.adaptive_avg_pool(xj, *out))


@pytest.mark.parametrize("hw", [(13, 16), (16, 13), (13, 19), (16, 24)])
def test_pad_images_for_dct_matches_jax(hw):
    """One pad 0 copies nothing (the quirk), both pads the corner only."""
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng.standard_normal((1, 2) + hw + (3,)))
    got, ph, pw = dct.pad_images_for_dct(xt)
    ref, jph, jpw = j_dct.pad_images_for_dct(xj)
    assert (ph, pw) == (jph, jpw) == (-hw[0] % 8, -hw[1] % 8)
    _equal(got, ref)
    h, w = hw
    if ph and pw:
        assert not got[:, :, h:, :w - pw].any()
        _equal(got[:, :, h:, w:], xj[:, :, h - ph:, w - pw:])
    elif ph or pw:
        assert not got[:, :, h:].any() and not got[:, :, :, w:].any()


def test_resize_flow_matches_jax():
    """FTVSR's case, flows of tens of pixels to 1/8 of the size, within
    1e-5.  At a ratio that is not a whole number torch's interpolate rounds
    its source coordinates in float32 where the JAX op builds its weights
    in float64, so the deviation grows with the flow's magnitude (3e-6 at
    |flow| 5, 5e-5 at 78, 40 -> 13 rows): that case is held to 2e-6 of the
    largest |flow|."""
    rng = np.random.default_rng(6)
    fj, ft = _pair(rng.standard_normal((3, 40, 56, 2)) * 20)
    _close(dct.resize_flow(ft, 5, 7), j_dct.resize_flow(fj, 5, 7))
    _close(dct.resize_flow(ft, 13, 9), j_dct.resize_flow(fj, 13, 9),
           2e-6 * float(ft.abs().max()))


def _half_coords(rng, n, size):
    """Coordinates from -2 to size + 1, a third of them exactly on .5."""
    c = rng.uniform(-2, size + 1, n)
    half = rng.random(n) < 1 / 3
    c[half] = np.floor(c[half]) + 0.5
    return c


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_nearest_matches_jax(padding):
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng.standard_normal((2, 7, 9, 5)))
    px, py = _half_coords(rng, 2 * 90, 9), _half_coords(rng, 2 * 90, 7)
    pxj, pxt = _pair(px.reshape(2, 90))
    pyj, pyt = _pair(py.reshape(2, 90))
    got = warp.grid_sample_nearest(xt, pxt, pyt, padding)
    _equal(got, j_warp.grid_sample_nearest(xj, pxj, pyj, padding))
    # torch's own nearest grid_sample, align_corners=True, away from .5
    # (its normalisation round trip moves x.5 by an ulp either way)
    grid = torch.stack([2 * pxt / 8 - 1, 2 * pyt / 6 - 1], -1)[:, None]
    ref = F.grid_sample(xt.permute(0, 3, 1, 2), grid, mode="nearest",
                        padding_mode=padding, align_corners=True)
    off = torch.from_numpy(((px % 1 != 0.5) & (py % 1 != 0.5)).reshape(2, 90))
    assert off.sum() > 60
    _equal(got[off], ref[:, :, 0].permute(0, 2, 1)[off].numpy())
    # x.5 rounds to even, where floor(x + 0.5) rounds up
    assert (np.round(px) != np.floor(px + 0.5)).any()


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
def test_flow_warp_interpolations_match_jax(padding, interpolation):
    rng = np.random.default_rng(8)
    xj, xt = _pair(rng.standard_normal((2, 5, 11, 2)))
    flow = np.round(rng.standard_normal((2, 5, 11, 2)) * 6) / 2  # on .5 too
    fj, ft = _pair(flow)
    _close(warp.flow_warp(xt, ft, padding, interpolation),
           j_warp.flow_warp(xj, fj, padding, interpolation))
    with pytest.raises(ValueError, match="interpolation"):
        warp.flow_warp(xt, ft, padding, "bicubic")
