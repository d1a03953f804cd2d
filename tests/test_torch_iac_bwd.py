"""The IAC chain's backward in the port against the JAX package, on the CPU.

The port's chain walk (the backward of ``fused_iac.IACChainFn``) runs here
with the plain per-iteration adjoint (``warp_sac_vjp_plain``) in place of
the CUDA kernel (csrc/iac_bwd.cu, tested against the same plain adjoint on
a GPU in tests/test_torch_kernels_gpu.py).  Bars: 2e-4, as tests/test_pallas_iac.py
holds the JAX fused adjoint: the two frameworks sum the SAC and warp
adjoints in other orders.

* Against ``jax.grad`` through the exact gather path at small, large and
  out-of-frame flows (where the TPU kernel's radius-2 window would clamp;
  the port must not).
* At small flows also against the JAX fused adjoint
  (``pallas_iac.iac_fused_vjp``) in interpret mode, one small case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.ops.pallas_iac import iac_fused_vjp as j_iac_fused_vjp
from fcvsr_tpu.ops.sac import iac as j_iac
from fcvsr_tpu_torch.ops import fused_iac, launch_counts

TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _case(seed, b, h, w, c, ac, flows):
    rng = np.random.default_rng(seed)
    feat_in = rng.standard_normal((b, h, w, c)).astype(np.float32)
    pred_k = (rng.standard_normal((b, h, w, ac * 3 * c)) * 0.3).astype(np.float32)
    if flows == "small":
        offsets = rng.uniform(-1.3, 1.3, (ac, b, h, w, 2))
    else:  # +-20 px and out-of-frame displacements beside small ones
        offsets = rng.uniform(-1.3, 1.3, (ac, b, h, w, 2))
        offsets[:, :, : h // 3] = rng.uniform(-20, 20, (ac, b, h // 3, w, 2))
        offsets[:, :, -2:, :, 0] += 3 * w
        offsets[:, :, :, :2, 1] -= 3 * h
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return feat_in, pred_k, offsets.astype(np.float32), g


def _port_grads(feat_in, pred_k, offsets, g, ac, act_last=True):
    """IACChainFn's gradients on CPU tensors."""
    leaves = [_t(a).requires_grad_() for a in (feat_in, pred_k, offsets)]
    out = fused_iac.IACChainFn.apply(*leaves, ac, act_last)
    return torch.autograd.grad(out, leaves, _t(g))


def _jax_grads(feat_in, pred_k, offsets, g, ac, c, act_last):
    def f(fi, pk, off):
        out = j_iac(fi, pk, off, ac, c, 3, act_last=act_last,
                    kernel1_both=True, k1_only=True, warp_impl="gather",
                    k_tap_major=True)
        return jnp.vdot(out, jnp.asarray(g))

    return jax.jit(jax.grad(f, (0, 1, 2)))(
        jnp.asarray(feat_in), jnp.asarray(pred_k), jnp.asarray(offsets))


@pytest.mark.parametrize("flows,act_last,h,w", [
    ("small", True, 12, 10),
    ("large", True, 13, 11),     # H, W odd
    ("large", False, 7, 9),      # H < 8, no activation on the last step
])
def test_iac_vjp_matches_jax_gather(flows, act_last, h, w):
    b, c, ac = 2, 8, 3
    feat_in, pred_k, offsets, g = _case(0, b, h, w, c, ac, flows)
    ref = _jax_grads(feat_in, pred_k, offsets, g, ac, c, act_last)
    got = _port_grads(feat_in, pred_k, offsets, g, ac, act_last)
    for name, r, a in zip(("dfeat_in", "dpred_k", "doffsets"), ref, got):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_iac_vjp_matches_jax_fused_adjoint_interpret():
    """The JAX fused adjoint (K5, interpret mode) at flows within its
    radius-2 window, where it is exact."""
    b, h, w, c, ac = 1, 16, 8, 8, 2
    feat_in, pred_k, offsets, g = _case(1, b, h, w, c, ac, "small")
    ref = j_iac_fused_vjp(jnp.asarray(feat_in), jnp.asarray(pred_k),
                          jnp.asarray(offsets), jnp.asarray(g), ac, c,
                          tile_rows=8, interpret=True)
    got = _port_grads(feat_in, pred_k, offsets, g, ac)
    for name, r, a in zip(("dfeat_in", "dpred_k", "doffsets"), ref, got):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_warp_sac_bwd_writes_only_its_block_on_cpu():
    """The adjoint wrapper on CPU tensors: the plain version, the other
    iterations' dk blocks untouched, no launch counted."""
    b, h, w, c, ac = 1, 5, 6, 4, 3
    feat_in, pred_k, offsets, g = _case(2, b, h, w, c, ac, "large")
    before = launch_counts()
    dk = torch.full(pred_k.shape, 7.0)
    dsrc, dflow, dk = fused_iac.warp_sac_bwd(_t(feat_in), _t(offsets[1]),
                                             _t(pred_k), _t(g), 1, dk)
    ref = fused_iac.warp_sac_vjp_plain(_t(feat_in), _t(offsets[1]),
                                       _t(pred_k), _t(g), 1)
    cols = slice(3 * c, 6 * c)
    torch.testing.assert_close(dk[..., cols], ref[2][..., cols], rtol=0,
                               atol=0)
    assert (dk[..., :3 * c] == 7).all() and (dk[..., 6 * c:] == 7).all()
    assert not ref[2][..., :3 * c].any() and not ref[2][..., 6 * c:].any()
    torch.testing.assert_close(dsrc, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(dflow, ref[1], rtol=0, atol=0)
    assert launch_counts() == before


def test_out_of_frame_flow_has_zero_gradient():
    """Where the coordinate clamp is active the flow gets no gradient, and a
    pixel whose four corners all lie outside the frame scatters nothing."""
    b, h, w, c = 1, 4, 5, 3
    rng = np.random.default_rng(3)
    src = _t(rng.standard_normal((b, h, w, c)))
    flow = np.zeros((b, h, w, 2), np.float32)
    flow[..., 0] = 100.0
    k = _t(rng.standard_normal((b, h, w, 3 * c)))
    gz = _t(rng.standard_normal((b, h, w, c)))
    dsrc, dflow, _ = fused_iac.warp_sac_vjp_plain(src, _t(flow), k, gz)
    assert not dsrc.any() and not dflow.any()
