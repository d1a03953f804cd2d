"""The port's plain deformable conv and the sampling ops the zoo adds,
against the JAX package on the CPU.

``fcvsr_tpu_torch.ops.dcn.modulated_deform_conv2d`` against
``fcvsr_tpu.ops.dcn.modulated_deform_conv2d`` on its default exact gather
path, with offsets of +-0.5, +-6 and out of the frame, a share of them
integers (samples exactly on a pixel, at -1 and at H or W); the wrapper of
the DCN kernel runs the same plain version for CPU tensors.  Tolerance:
2e-5 x max(1, max |ref|), f32 sums of up to 9 x Cin products in another
order.  ``flow_warp(padding_mode='border')`` and
``resize_bilinear(align_corners=True)`` (SPyNet's) against the JAX ops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.ops.dcn import modulated_deform_conv2d as j_dcn
from fcvsr_tpu.ops.resize import resize_bilinear as j_resize
from fcvsr_tpu.ops.warp import flow_warp as j_flow_warp
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.ops.dcn import modulated_deform_conv2d
from fcvsr_tpu_torch.ops.fused_dcn import modulated_deform_conv2d_fused
from fcvsr_tpu_torch.ops.resize import resize_bilinear
from fcvsr_tpu_torch.ops.warp import flow_warp

RTOL = 2e-5


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    tol = rtol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (err, tol)


def _offsets(rng, b, h, w, n, scale):
    """Offsets of +-scale; every third channel rounded to an integer; the
    bottom rows pushed below the frame (dy) and the left columns left of
    it (dx)."""
    off = rng.standard_normal((b, h, w, n)) * scale
    off[..., ::3] = np.round(off[..., ::3])
    off[:, -max(1, h // 4):, :, 0::2] += 2 * h
    off[:, :, : max(1, w // 4), 1::2] -= 2 * w
    return off.astype(np.float32)


def _case(seed, b, h, w, cin, cout, dg, scale, with_mask, ho=None, wo=None):
    rng = np.random.default_rng(seed)
    ho, wo = ho or h, wo or w
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    off = _offsets(rng, b, ho, wo, dg * 18, scale)
    mask = rng.uniform(0, 1, (b, ho, wo, dg * 9)).astype(np.float32) \
        if with_mask else None
    return x, off, mask, rng


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("b,h,w,cin,cout,dg,scale,with_mask", [
    (2, 7, 9, 24, 10, 3, 6.0, True),      # v2, dg 3, +-6 px
    (1, 5, 6, 8, 4, 1, 0.5, True),        # v2, dg 1, sub-pixel
    (1, 11, 13, 64, 16, 8, 6.0, True),    # v2, dg 8 (EDVR's layout)
    (2, 6, 5, 24, 7, 3, 0.5, False),      # v1 (no mask)
    (1, 9, 7, 16, 12, 8, 6.0, False),     # v1, dg 8
])
def test_plain_dcn_matches_jax(b, h, w, cin, cout, dg, scale, with_mask):
    x, off, mask, rng = _case(b * h + cin, b, h, w, cin, cout, dg, scale,
                              with_mask)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    ref = j_dcn(_j(x), _j(off), _j(mask), _j(wt), _j(bias), deform_groups=dg)
    before = launch_counts()
    for fn in (modulated_deform_conv2d, modulated_deform_conv2d_fused):
        got = fn(_t(x), _t(off), _t(mask), _t(wt), _t(bias), deform_groups=dg)
        _close(got, ref)
    assert launch_counts() == before


def test_plain_dcn_strided_grouped_matches_jax():
    """The plain version takes every configuration of the JAX op: stride 2,
    padding 2, dilation 2, two conv groups."""
    x, off, mask, rng = _case(7, 1, 12, 11, 8, 6, 2, 3.0, True, ho=6, wo=6)
    wt = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    kw = dict(stride=2, padding=2, dilation=2, groups=2, deform_groups=2)
    ref = j_dcn(_j(x), _j(off), _j(mask), _j(wt), None, **kw)
    _close(modulated_deform_conv2d(_t(x), _t(off), _t(mask), _t(wt), None,
                                   **kw), ref)


def test_plain_dcn_zero_offsets_is_a_conv():
    """Zero offsets and a unit mask: the 3x3 SAME conv."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 7, 16)).astype(np.float32))
    wt = torch.from_numpy(rng.standard_normal((3, 3, 16, 5)).astype(np.float32))
    got = modulated_deform_conv2d(x, torch.zeros(2, 6, 7, 4 * 18),
                                  torch.ones(2, 6, 7, 4 * 9), wt,
                                  deform_groups=4)
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                     wt.permute(3, 2, 0, 1), padding=1)
    _close(got, ref.permute(0, 2, 3, 1), 1e-5)


@pytest.mark.parametrize("scale", [0.7, 9.0])
def test_flow_warp_border_matches_jax(scale):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 12, 3)).astype(np.float32)
    flow = _offsets(rng, 2, 9, 12, 2, scale)
    ref = j_flow_warp(_j(x), _j(flow), padding_mode="border")
    _close(flow_warp(_t(x), _t(flow), padding_mode="border"), ref)


@pytest.mark.parametrize("hw,out", [((4, 6), (8, 12)), ((1, 3), (2, 6)),
                                    ((5, 7), (11, 9))])
def test_resize_align_corners_matches_jax(hw, out):
    x = np.random.default_rng(6).standard_normal((2,) + hw + (2,)) \
        .astype(np.float32)
    ref = j_resize(_j(x), *out, align_corners=True)
    _close(resize_bilinear(_t(x), *out, align_corners=True), ref)
