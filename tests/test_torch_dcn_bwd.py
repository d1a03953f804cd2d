"""The port's plain DCN adjoint (``ops.dcn.modulated_deform_conv2d_vjp``,
the plain version of ``csrc/dcn_bwd.cu``) against the JAX package on the
CPU, and the DCN's autograd Function on CPU tensors.

* Against ``jax.vjp`` of ``fcvsr_tpu.ops.dcn._gather_forward``, the exact
  path: DCNv2 and DCNv1, deform groups 1, 2, 3, 8 and 16 (8 channels a
  group at 8 and 16, as EDVR-M and BasicVSR++ have), offsets of +-0.5 px,
  +-6 px and out of the frame.  Every sample point's fractional part lies
  in [0.1, 0.4] or [0.6, 0.9]: a point within f32 noise of an integer (or
  of the zero ring's clamp at -1.5) moves its floor between the two
  frameworks and changes its derivative by a whole pixel difference.
  Tolerance 1e-4 x max(1, max |ref|): f32 sums in another order, the
  weight gradient over every pixel.
* Against ``fcvsr_tpu.ops.pallas_dcn.modulated_deform_conv2d_fused_vjp``
  (the function the CUDA adjoint replaces), in interpret mode as
  ``tests/test_pallas_dcn.py`` runs it, with offsets well inside its 2 px
  radius, where it is exact, at that file's tolerance (2e-4).
* ``DCNFn`` on CPU tensors (forward and backward run the plain versions)
  against autograd through the plain forward, and no kernel launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.ops.dcn import _gather_forward
from fcvsr_tpu.ops.pallas_dcn import modulated_deform_conv2d_fused_vjp as \
    j_fused_vjp
from fcvsr_tpu_torch.ops import launch_counts
from fcvsr_tpu_torch.ops.dcn import (modulated_deform_conv2d,
                                     modulated_deform_conv2d_vjp)
from fcvsr_tpu_torch.ops.fused_dcn import (DCNFn,
                                           modulated_deform_conv2d_fused_vjp)

RTOL = 1e-4
NAMES = ("dx", "doffset", "dmask", "dweight", "dbias")


def _close(got, ref, name, rtol=RTOL, atol=None):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    tol = atol if atol is not None else rtol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, (name, err, tol)


def _offsets(rng, b, h, w, n, scale):
    """Offsets of +-scale whose fractional parts stay in [0.1, 0.4] or
    [0.6, 0.9]; the bottom rows pushed below the frame (dy) and the left
    columns left of it (dx) by whole pixels."""
    whole = np.floor(rng.standard_normal((b, h, w, n)) * scale)
    frac = rng.uniform(0.1, 0.4, whole.shape) + 0.5 * rng.integers(0, 2,
                                                                   whole.shape)
    off = whole + frac
    off[:, -max(1, h // 4):, :, 0::2] += 2 * h
    off[:, :, : max(1, w // 4), 1::2] -= 2 * w
    return off.astype(np.float32)


def _case(seed, b, h, w, cin, cout, dg, scale, with_mask, off_fn=_offsets):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    off = off_fn(rng, b, h, w, dg * 18, scale)
    mask = rng.uniform(0, 1, (b, h, w, dg * 9)).astype(np.float32) \
        if with_mask else None
    wt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)) \
        .astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    g = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, off, mask, wt, bias, g


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jax_vjp(x, off, mask, wt, bias, g, dg):
    args = [jnp.asarray(a) for a in (x, off, mask, wt, bias) if a is not None]

    def f(*a):
        a = list(a)
        m = a.pop(2) if mask is not None else None
        return _gather_forward(a[0], a[1], m, a[2], a[3], deform_groups=dg)

    grads = list(jax.jit(lambda a, ct: jax.vjp(f, *a)[1](ct))(
        args, jnp.asarray(g)))
    if mask is None:
        grads.insert(2, None)
    return grads


@pytest.mark.parametrize("b,h,w,cin,cout,dg,scale,with_mask", [
    (2, 7, 9, 24, 10, 3, 6.0, True),      # v2, dg 3, +-6 px
    (1, 6, 5, 8, 12, 1, 0.5, True),       # v2, dg 1, sub-pixel
    (1, 9, 11, 16, 8, 2, 6.0, False),     # v1, dg 2
    (1, 11, 13, 64, 16, 8, 6.0, True),    # v2, dg 8 (EDVR-M's layout)
    (2, 8, 7, 64, 12, 8, 0.5, False),     # v1, dg 8
    (1, 8, 10, 128, 16, 16, 6.0, True),   # v2, dg 16 (BasicVSR++'s layout)
])
def test_plain_vjp_matches_jax(b, h, w, cin, cout, dg, scale, with_mask):
    x, off, mask, wt, bias, g = _case(b * h + cin + dg, b, h, w, cin, cout,
                                      dg, scale, with_mask)
    ref = _jax_vjp(x, off, mask, wt, bias, g, dg)
    got = modulated_deform_conv2d_vjp(_t(x), _t(off), _t(mask), _t(wt),
                                      _t(bias), _t(g), dg)
    for name, a, r in zip(NAMES, got, ref):
        assert (a is None) == (r is None), name
        if r is not None:
            _close(a, r, name)
    # the offsets reach out of the frame and several pixels away
    assert float(np.abs(off).max()) > h


def test_plain_vjp_without_bias_matches_jax():
    x, off, mask, wt, _, g = _case(3, 1, 6, 7, 16, 9, 4, 3.0, True)
    ref = _jax_vjp(x, off, mask, wt, np.zeros(9, np.float32), g, 4)
    got = modulated_deform_conv2d_vjp(_t(x), _t(off), _t(mask), _t(wt), None,
                                      _t(g), 4)
    assert got[4] is None
    for name, a, r in zip(NAMES[:4], got, ref):
        _close(a, r, name)


def _small_offsets(rng, b, h, w, n, scale):
    """Uniform +-scale, well inside the TPU kernel's 2 px radius."""
    return rng.uniform(-scale, scale, (b, h, w, n)).astype(np.float32)


@pytest.mark.parametrize("with_mask", [True, False])
def test_plain_vjp_matches_the_tpu_kernels_vjp(with_mask):
    """The Pallas adjoint (interpret mode) is exact where every offset's
    deviation from its tile's mean stays within the 2 px radius."""
    x, off, mask, wt, bias, g = _case(11, 1, 8, 16, 16, 16, 2, 1.2,
                                      with_mask, _small_offsets)
    ref = j_fused_vjp(*(None if a is None else jnp.asarray(a)
                        for a in (x, off, mask, wt, bias, g)),
                      deform_groups=2, interpret=True)
    got = modulated_deform_conv2d_vjp(_t(x), _t(off), _t(mask), _t(wt),
                                      _t(bias), _t(g), 2)
    for name, a, r in zip(NAMES, got, ref):
        assert (a is None) == (r is None), name
        if r is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-4,
                                       atol=2e-4, err_msg=name)


@pytest.mark.parametrize("with_mask,with_bias", [(True, True),
                                                 (False, False)])
def test_dcn_function_on_cpu_matches_autograd(with_mask, with_bias):
    """DCNFn's forward and backward on CPU tensors go to the plain
    versions: the same gradients as autograd through the plain forward, the
    wrapper of the adjoint gives the same five tensors, and no launch is
    counted."""
    x, off, mask, wt, bias, g = _case(13, 2, 5, 6, 16, 8, 2, 3.0, with_mask)
    bias = bias if with_bias else None
    before = launch_counts()

    def grads(fn):
        ins = [None if a is None else _t(a).clone().requires_grad_()
               for a in (x, off, mask, wt, bias)]
        out = fn(*ins)
        out.backward(_t(g))
        return out.detach(), [None if t is None else t.grad for t in ins]

    out, got = grads(lambda *a: DCNFn.apply(*a, 2))
    ref_out, ref = grads(lambda *a: modulated_deform_conv2d(
        *a, deform_groups=2))
    _close(out, ref_out, "out", 1e-6)
    wrapped = modulated_deform_conv2d_fused_vjp(
        _t(x), _t(off), _t(mask), _t(wt), _t(bias), _t(g), 2)
    for name, a, r, v in zip(NAMES, got, ref, wrapped):
        assert (a is None) == (r is None) == (v is None), name
        if r is not None:
            _close(a, r, name, 1e-6)
            _close(v, r, name, 1e-6)
    assert launch_counts() == before
