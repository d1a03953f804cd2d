"""The IAC iteration's kernel prediction on the tensor cores (K1's kf mode,
csrc/iac.cu), emulated on the CPU: ``fused_iac.predict_kernels_emulated``
rounds f0 and Wsel to bf16 (or TF32) on their bits, splits them into high
and low parts and sums the route's products in float32, as the kernel's
mma.sync do.  At a small iteration (C 16, C0 5 and 64, Wsel at 0.2, flows
of a few pixels, seeded with numpy) each route's iteration is held to the
float64 iteration and to the plain kf version (float32 einsum):

  - float32 f0: 3xTF32 (the kernel's route) within IAC_RTOL = 2e-5 of
    max(1, max|out|), the bar chip_smoke.py and the GPU tests hold the
    kernel to; one bf16 pass and one TF32 pass miss it at C0 64, and
    bf16x3 (K2's route) misses it on the inputs of the GPU test
    test_iac_kf_kernel_matches_plain[11-21-24-5] (C0 5), as the kernel
    did there on the card;
  - bf16 f0 (values exact in bf16, held in float32 so that only the
    prediction's route differs): two passes, f0 w_hi + f0 w_lo (the
    kernel's), within the same bar.

The emulated chain is also held to the JAX package's gather path with the
same factors (``fcvsr_tpu.ops.sac.iac`` with ``k_parts``), and Wsel's bf16
planes (``fused_iac.wsel_planes``, the kernel's B operand) to Wsel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fcvsr_tpu.ops.sac import iac as j_iac
from fcvsr_tpu_torch.ops import fused_iac
from fcvsr_tpu_torch.ops.sac import sac
from fcvsr_tpu_torch.ops.warp import flow_warp

IAC_RTOL = 2e-5


def _case(c0, seed=0, b=1, h=9, w=13, c=16, n_it=2):
    rng = np.random.default_rng(seed)
    return dict(
        feat=rng.standard_normal((b, h, w, c)),
        fin=rng.standard_normal((b, h, w, c)),
        flow=rng.standard_normal((b, h, w, 2)) * 3.0,
        f0=rng.standard_normal((b, h, w, c0)),
        wsel=rng.standard_normal((c0, n_it * 3 * c)) * 0.2,
        bsel=rng.standard_normal(n_it * 3 * c) * 0.1, c=c)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _f0(p, f0_dtype):
    """f0 as float32, its values rounded to bf16 for a bf16 f0."""
    return _t(p["f0"]).to(f0_dtype).float()


def _f64_iteration(p, f0, it, act):
    """The iteration in float64: k = f0 . wsel + bsel, then warp, SAC,
    residual and activation."""
    c = p["c"]
    cols = slice(it * 3 * c, (it + 1) * 3 * c)
    k = torch.einsum("bhwc,ck->bhwk", f0.double(),
                     _t(p["wsel"], torch.float64)[:, cols]) \
        + _t(p["bsel"], torch.float64)[cols]
    out = sac(flow_warp(_t(p["feat"], torch.float64),
                        _t(p["flow"], torch.float64)), k, k, 3,
              tap_major=True) + _t(p["fin"], torch.float64)
    return F.leaky_relu(out, 0.1) if act else out


def _route_iteration(p, f0, it, act, route):
    k = fused_iac.predict_kernels_emulated(f0, _t(p["wsel"]), _t(p["bsel"]),
                                           it, p["c"], route)
    return fused_iac.warp_sac_plain(_t(p["feat"]), _t(p["flow"]), k,
                                    _t(p["fin"]), act)


def _err(got, ref):
    scale = max(1.0, float(ref.abs().max()))
    return float((got.double() - ref.double()).abs().max()) / scale


@pytest.mark.parametrize("c0", [5, 64])
@pytest.mark.parametrize("f0_dtype,route", [(torch.float32, "3xtf32"),
                                            (torch.bfloat16, "bf16_w2")])
def test_kf_route_against_float64_and_plain(c0, f0_dtype, route):
    """The kernel's route for each f0 type, both iterations, against the
    float64 iteration and the plain kf version, at the kernel's bar."""
    p = _case(c0)
    f0 = _f0(p, f0_dtype)
    for it, act in ((0, True), (1, False)):
        got = _route_iteration(p, f0, it, act, route)
        assert _err(got, _f64_iteration(p, f0, it, act)) <= IAC_RTOL
        plain = fused_iac.warp_sac_plain(
            _t(p["feat"]), _t(p["flow"]),
            fused_iac.predict_kernels(f0, _t(p["wsel"]), _t(p["bsel"]), it,
                                      p["c"]), _t(p["fin"]), act)
        assert _err(got, plain) <= IAC_RTOL, (it, _err(got, plain))


def _gpu_case():
    """The inputs of test_iac_kf_kernel_matches_plain[11-21-24-5]
    (tests/test_torch_kernels_gpu.py), iteration 1."""
    def r(seed, *shape, scale=1.0):
        return np.random.default_rng(seed).standard_normal(shape) * scale

    h, w, c, c0 = 11, 21, 24, 5
    return dict(feat=r(4, 1, h, w, c), fin=r(5, 1, h, w, c),
                flow=r(6, 1, h, w, 2, scale=5.0), f0=r(7, 1, h, w, c0),
                wsel=r(8, c0, 2 * 3 * c, scale=0.2),
                bsel=r(9, 2 * 3 * c, scale=0.1), c=c), 1


@pytest.mark.parametrize("case,route,holds", [
    ("c0_64", "3xtf32", True), ("c0_64", "bf16x3", True),
    ("c0_64", "bf16", False), ("c0_64", "tf32", False),
    ("gpu_c0_5", "3xtf32", True), ("gpu_c0_5", "bf16x3", False)])
def test_float32_f0_routes(case, route, holds):
    """Why float32 f0 takes 3xTF32: one bf16 or TF32 pass misses the bar
    at FCVSR's C0 of 64 (by 120x and 25x), bf16x3 holds it there by 3x
    but misses it (by 8%) on the GPU test's C0 5 inputs; 3xTF32 holds both
    by 20x or more, near the plain float32 version's own error."""
    p, it = (_case(64, seed=1), 0) if case == "c0_64" else _gpu_case()
    f0 = _f0(p, torch.float32)
    ref = _f64_iteration(p, f0, it, True)
    err = _err(_route_iteration(p, f0, it, True, route), ref)
    assert (err <= IAC_RTOL) == holds, (route, err)
    if route == "3xtf32":
        assert err <= IAC_RTOL / 20, err


def test_emulated_chain_matches_jax_gather():
    """Two iterations with the emulated prediction (3xTF32) against the JAX
    package's gather path with the same factors, at the kernel's bar."""
    p = _case(6, seed=2, h=7, w=10, c=8)
    ac, c = 2, p["c"]
    offs = np.stack([p["flow"], p["flow"][:, ::-1] * 0.5])
    ref = j_iac(jnp.asarray(p["fin"], jnp.float32), None,
                jnp.asarray(offs, jnp.float32), ac, c, 3, kernel1_both=True,
                k1_only=True, warp_impl="gather", k_tap_major=True,
                k_parts=(jnp.asarray(p["f0"], jnp.float32),
                         jnp.asarray(p["wsel"], jnp.float32),
                         jnp.asarray(p["bsel"], jnp.float32)))
    cur = fin = _t(p["fin"])
    for i in range(ac):
        k = fused_iac.predict_kernels_emulated(_t(p["f0"]), _t(p["wsel"]),
                                               _t(p["bsel"]), i, c, "3xtf32")
        cur = fused_iac.warp_sac_plain(cur, _t(offs[i].copy()), k, fin, True)
    assert _err(cur, torch.from_numpy(np.array(ref))) <= IAC_RTOL


def test_wsel_planes_split_once_a_weight_version():
    """The kernel's B operand: Wsel's transpose as bf16 hi and lo planes
    (or TF32 ones, in float32), C0 padded to 16 with zeros, hi + lo within
    2^-16 (2^-22) of Wsel; made once for a tensor and again after it is
    written to."""
    w = _t(np.random.default_rng(3).standard_normal((5, 36)))
    planes = fused_iac.wsel_planes(w)
    assert planes.shape == (2, 36, 16) and planes.dtype == torch.bfloat16
    assert fused_iac.wsel_planes(w) is planes
    back = (planes[0].float() + planes[1].float())[:, :5].t()
    assert float(((back - w).abs() / w.abs()).max()) <= 2.0 ** -16
    assert not planes[:, :, 5:].any()
    tf = fused_iac.wsel_planes(w, tf32=True)
    assert tf.dtype == torch.float32 and tf.shape == (2, 36, 16)
    assert fused_iac.wsel_planes(w, tf32=True) is tf
    back = (tf[0] + tf[1])[:, :5].t()
    assert float(((back - w).abs() / w.abs()).max()) <= 2.0 ** -22
    assert torch.equal(tf[0].view(torch.int32) & 0x1FFF,
                       torch.zeros_like(tf[0], dtype=torch.int32))
    w.mul_(2.0)
    again = fused_iac.wsel_planes(w)
    assert again is not planes
    assert torch.equal(again[0].float(), 2.0 * planes[0].float())
