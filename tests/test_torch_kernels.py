"""The plain versions of the port's kernels against the JAX package, on the
CPU (the kernels themselves run only on a GPU: tests/test_torch_kernels_gpu.py).

* IAC: ``fused_iac`` against ``fcvsr_tpu.ops.sac.iac(warp_impl='gather')``
  at 1e-5 (same f32 arithmetic), and against the Pallas kernels in interpret
  mode at 1e-4 with |flow| <= 1.5 px, where their radius-2 clamp is inactive
  (they accumulate the 36-tap warp stencil in another order).
* Convs: ``fused_conv`` against XLA convs at 1e-5 (f32), and against the
  Pallas rows kernels in interpret mode at 2e-2 relative (those run
  single-pass bf16 matmuls).
* SCNet through the kernel wrappers against the JAX SCNet at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.models.blocks import SCNet as JSCNet
from fcvsr_tpu.ops.pallas_conv import (conv3x3_pair_rows, conv3x3_rows,
                                       pad_to_rows, prep_weight, rows_to_nhwc)
from fcvsr_tpu.ops.pallas_iac import iac_fused as j_iac_fused
from fcvsr_tpu.ops.pallas_iac import iac_fused_kf as j_iac_fused_kf
from fcvsr_tpu.ops.sac import iac as j_iac
from fcvsr_tpu_torch.models.blocks import SCNet
from fcvsr_tpu_torch.ops import fused_conv, fused_dcn, fused_iac, launch_counts
from fcvsr_tpu_torch.ops.sac import iac
from fcvsr_tpu_torch.utils.convert import state_dict_from_jax

ATOL = 1e-5


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _iac_inputs(seed, b, h, w, c, ac, flow_scale):
    rng = np.random.default_rng(seed)
    feat_in = rng.standard_normal((b, h, w, c)).astype(np.float32)
    pred_k = (rng.standard_normal((b, h, w, ac * 3 * c)) * 0.3).astype(np.float32)
    offsets = (rng.standard_normal((ac, b, h, w, 2)) * flow_scale).astype(np.float32)
    return feat_in, pred_k, offsets


@pytest.mark.parametrize("h,w,flow_scale,act_last", [
    (16, 12, 0.8, True),
    (13, 11, 7.0, True),     # H not a multiple of 8, large flows
    (6, 9, 30.0, False),     # H < 10, mostly out-of-frame flows
])
def test_iac_plain_matches_jax_gather(h, w, flow_scale, act_last):
    b, c, ac = 2, 8, 3
    feat_in, pred_k, offsets = _iac_inputs(0, b, h, w, c, ac, flow_scale)
    ref = j_iac(jnp.asarray(feat_in), jnp.asarray(pred_k), jnp.asarray(offsets),
                ac, c, 3, act_last=act_last, kernel1_both=True, k1_only=True,
                warp_impl="gather", k_tap_major=True)
    got = fused_iac.iac_fused(_t(feat_in), _t(pred_k), _t(offsets), ac, c,
                              act_last=act_last)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("h,flow_scale", [(11, 5.0), (7, 25.0)])
def test_iac_kf_plain_matches_jax_gather(h, flow_scale):
    b, w, c, c0, ac = 1, 10, 8, 6, 2
    rng = np.random.default_rng(1)
    feat_in, _, offsets = _iac_inputs(1, b, h, w, c, ac, flow_scale)
    f0 = rng.standard_normal((b, h, w, c0)).astype(np.float32)
    wsel = (rng.standard_normal((c0, ac * 3 * c)) * 0.2).astype(np.float32)
    bsel = (rng.standard_normal(ac * 3 * c) * 0.1).astype(np.float32)
    ref = j_iac(jnp.asarray(feat_in), None, jnp.asarray(offsets), ac, c, 3,
                kernel1_both=True, k1_only=True, warp_impl="gather",
                k_tap_major=True,
                k_parts=(jnp.asarray(f0), jnp.asarray(wsel), jnp.asarray(bsel)))
    got = iac(_t(feat_in), None, _t(offsets), ac, c,
              k_parts=(_t(f0), _t(wsel), _t(bsel)))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("act_last", [True, False])
def test_iac_matches_jax_gather(act_last):
    """``ops.sac.iac``, the entry MGAA calls, with materialised kernels."""
    b, h, w, c, ac = 1, 9, 8, 4, 2
    feat_in, pred_k, offsets = _iac_inputs(2, b, h, w, c, ac, 3.0)
    ref = j_iac(jnp.asarray(feat_in), jnp.asarray(pred_k), jnp.asarray(offsets),
                ac, c, 3, act_last=act_last, kernel1_both=True, k1_only=True,
                warp_impl="gather", k_tap_major=True)
    got = iac(_t(feat_in), _t(pred_k), _t(offsets), ac, c, act_last=act_last)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kf", [False, True])
def test_iac_plain_matches_pallas_interpret(kf):
    b, h, w, c, c0, ac = 1, 16, 12, 8, 8, 2
    rng = np.random.default_rng(3)
    feat_in, pred_k, _ = _iac_inputs(3, b, h, w, c, ac, 0.0)
    offsets = rng.uniform(-1.5, 1.5, (ac, b, h, w, 2)).astype(np.float32)
    if kf:
        f0 = rng.standard_normal((b, h, w, c0)).astype(np.float32)
        wsel = (rng.standard_normal((c0, ac * 3 * c)) * 0.2).astype(np.float32)
        bsel = (rng.standard_normal(ac * 3 * c) * 0.1).astype(np.float32)
        ref = j_iac_fused_kf(jnp.asarray(feat_in), jnp.asarray(f0),
                             jnp.asarray(wsel), jnp.asarray(bsel),
                             jnp.asarray(offsets), ac, c, tile_rows=8,
                             interpret=True)
        got = fused_iac.iac_fused_kf(_t(feat_in), _t(f0), _t(wsel), _t(bsel),
                                     _t(offsets), ac, c)
    else:
        ref = j_iac_fused(jnp.asarray(feat_in), jnp.asarray(pred_k),
                          jnp.asarray(offsets), ac, c, tile_rows=8,
                          interpret=True)
        got = fused_iac.iac_fused(_t(feat_in), _t(pred_k), _t(offsets), ac, c)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=1e-4)


def _xla_conv(x, w, b):
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    return y if b is None else y + jnp.asarray(b)


def _conv_case(seed, h, w, cin, c1, cout, bias):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, cin, c1)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c1, cout)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(c1) * 0.1).astype(np.float32) if bias else None
    b2 = (rng.standard_normal(cout) * 0.1).astype(np.float32) if bias else None
    return x, w1, b1, w2, b2


def _opt(a):
    return None if a is None else _t(a)


@pytest.mark.parametrize("bias,ns1,c1", [(True, 0.1, 32), (False, 0.2, 16)])
def test_pair_plain_matches_xla(bias, ns1, c1):
    """conv2(lrelu(conv1(x) + b1)) + b2 with SAME zero padding of both."""
    x, w1, b1, w2, b2 = _conv_case(4, 9, 13, 16, c1, 16, bias)
    mid = _xla_conv(x, w1, b1)
    ref = _xla_conv(jnp.where(mid >= 0, mid, ns1 * mid), w2, b2)
    got = fused_conv.conv3x3_pair(_t(x), _t(w1), _opt(b1), _t(w2), _opt(b2),
                                  ns1)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("cout,res,act", [(16, True, False), (3, False, True),
                                          (1, True, True)])
def test_conv_plain_matches_xla(cout, res, act):
    x, _, _, w2, b2 = _conv_case(5, 10, 7, 16, 16, cout, True)
    r = np.random.default_rng(6).standard_normal((2, 10, 7, cout)).astype(np.float32)
    ref = _xla_conv(x, w2, b2) + (jnp.asarray(r) if res else 0.0)
    if act:
        ref = jnp.where(ref >= 0, ref, 0.2 * ref)
    got = fused_conv.conv3x3(_t(x), _t(w2), _t(b2), _t(r) if res else None,
                             act=act)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=ATOL)


def test_pair_plain_matches_pallas_interpret():
    h, w = 16, 12
    x, w1, b1, w2, b2 = _conv_case(7, h, w, 16, 32, 16, True)
    ref = rows_to_nhwc(conv3x3_pair_rows(
        pad_to_rows(jnp.asarray(x), 8), prep_weight(jnp.asarray(w1)),
        jnp.asarray(b1), prep_weight(jnp.asarray(w2)), jnp.asarray(b2),
        h=h, w=w, ns1=0.1, tile_rows=8, interpret=True), h, w)
    got = fused_conv.conv3x3_pair(_t(x), _t(w1), _t(b1), _t(w2), _t(b2), 0.1)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-2, atol=2e-2)


def test_conv_plain_matches_pallas_interpret():
    h, w = 16, 12
    x, _, _, w2, b2 = _conv_case(8, h, w, 16, 16, 16, True)
    r = np.random.default_rng(9).standard_normal((2, h, w, 16)).astype(np.float32)
    ref = rows_to_nhwc(conv3x3_rows(
        pad_to_rows(jnp.asarray(x), 8), prep_weight(jnp.asarray(w2)),
        jnp.asarray(b2), res=pad_to_rows(jnp.asarray(r), 8), h=h, w=w,
        tile_rows=8, interpret=True), h, w)
    got = fused_conv.conv3x3(_t(x), _t(w2), _t(b2), res=_t(r))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("nf,groups", [(16, 2), (8, 1)])
def test_scnet_matches_jax(nf, groups):
    """SCNet at 16x16 / 8x8 / 4x4 through the kernel wrappers (their plain
    versions on the CPU) against the JAX SCNet."""
    rng = np.random.default_rng(10)
    xs = [rng.standard_normal((1, s, s, nf)).astype(np.float32)
          for s in (16, 8, 4)]
    jm = JSCNet(nf, groups)
    params = jm.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs])
    ref = jm.apply(params, [jnp.asarray(x) for x in xs])
    sd = {k[len("recorb1."):]: v for k, v in
          state_dict_from_jax({"recorb1": params["params"]}).items()}
    port = SCNet(nf, groups)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port([_t(x) for x in xs])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(r), rtol=0, atol=ATOL)


def test_wrappers_on_cpu_leave_launch_counts_at_zero():
    x, w1, b1, w2, b2 = _conv_case(11, 5, 6, 8, 8, 8, True)
    feat_in, pred_k, offsets = _iac_inputs(11, 1, 5, 6, 8, 1, 1.0)
    before = launch_counts()
    fused_conv.conv3x3_pair(_t(x), _t(w1), _t(b1), _t(w2), _t(b2))
    fused_conv.conv3x3(_t(x), _t(w1), _t(b1))
    fused_iac.warp_sac_fused(_t(feat_in), _t(offsets[0]), _t(pred_k),
                             _t(feat_in))
    fused_iac.warp_sac_bwd(_t(feat_in), _t(offsets[0]), _t(pred_k),
                           _t(feat_in))
    fused_dcn.modulated_deform_conv2d_fused(
        _t(x), torch.zeros(2, 5, 6, 18), None, _t(w1), _t(b1))
    assert launch_counts() == before == {"iac": 0, "iac_bwd": 0,
                                         "conv3x3_pair": 0, "conv3x3": 0,
                                         "dcn": 0}
