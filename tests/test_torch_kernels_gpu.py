"""The port's CUDA kernels against their plain versions, on a GPU.

Skips without a CUDA device.  The machine with the card has no JAX, so run
these without the repository's conftest (which configures JAX):

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Shapes are small and odd: H and W not multiples of the tiles (IAC 8x16,
conv 8x16 / 16x16), channel counts not multiples of the 16-channel chunks,
C_out 1 and 3.  Tolerance: f32 against f32 in another summation order,
2e-5 (IAC) and 1e-4 (convs) times max(1, max |plain|).
"""

import numpy as np
import pytest
import torch

from fcvsr_tpu_torch.models import FCVSRNet, init_weights
from fcvsr_tpu_torch.ops import fused_conv, fused_iac

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(dev, seed, *shape, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def _assert_close(got, ref, rtol):
    torch.cuda.synchronize()
    tol = rtol * max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("h,w,c,flow_scale,act", [
    (13, 29, 20, 2.0, True), (5, 7, 64, 25.0, False), (40, 33, 8, 400.0, True)])
def test_iac_kernel_matches_plain(cuda, h, w, c, flow_scale, act):
    b, n_it = 2, 3
    feat = _rand(cuda, 0, b, h, w, c)
    fin = _rand(cuda, 1, b, h, w, c)
    flow = _rand(cuda, 2, b, h, w, 2, scale=flow_scale)
    k = _rand(cuda, 3, b, h, w, n_it * 3 * c, scale=0.3)
    n0 = fused_iac.warp_sac_fused.launches
    for it in range(n_it):
        got = fused_iac.warp_sac_fused(feat, flow, k, fin, act, it)
        ref = fused_iac.warp_sac_plain(feat, flow, k, fin, act, it)
        _assert_close(got, ref, 2e-5)
    assert fused_iac.warp_sac_fused.launches == n0 + n_it


@pytest.mark.parametrize("h,w,c,c0", [(11, 21, 24, 5), (17, 16, 64, 64)])
def test_iac_kf_kernel_matches_plain(cuda, h, w, c, c0):
    b, n_it = 1, 2
    feat = _rand(cuda, 4, b, h, w, c)
    fin = _rand(cuda, 5, b, h, w, c)
    flow = _rand(cuda, 6, b, h, w, 2, scale=5.0)
    f0 = _rand(cuda, 7, b, h, w, c0)
    wsel = _rand(cuda, 8, c0, n_it * 3 * c, scale=0.2)
    bsel = _rand(cuda, 9, n_it * 3 * c, scale=0.1)
    for it in range(n_it):
        got = fused_iac.warp_sac_fused_kf(feat, flow, f0, wsel, bsel, fin,
                                          True, it)
        k = fused_iac.predict_kernels(f0, wsel, bsel, it, c)
        ref = fused_iac.warp_sac_plain(feat, flow, k, fin, True)
        _assert_close(got, ref, 2e-5)


@pytest.mark.parametrize("h,w,cin,c1,cout,bias", [
    (9, 19, 64, 128, 64, True), (17, 5, 24, 40, 3, False), (3, 34, 8, 16, 1, True)])
def test_pair_kernel_matches_plain(cuda, h, w, cin, c1, cout, bias):
    x = _rand(cuda, 10, 2, h, w, cin)
    w1 = _rand(cuda, 11, 3, 3, cin, c1, scale=0.1)
    w2 = _rand(cuda, 12, 3, 3, c1, cout, scale=0.1)
    b1 = _rand(cuda, 13, c1) if bias else None
    b2 = _rand(cuda, 14, cout) if bias else None
    got = fused_conv.conv3x3_pair(x, w1, b1, w2, b2, 0.2)
    ref = fused_conv.conv3x3_pair_plain(x, w1, b1, w2, b2, 0.2)
    _assert_close(got, ref, 1e-4)


@pytest.mark.parametrize("h,w,cin,cout,res,act", [
    (9, 21, 64, 64, True, False), (35, 18, 64, 1, False, False),
    (13, 17, 20, 3, True, True), (4, 5, 7, 70, False, True)])
def test_conv_kernel_matches_plain(cuda, h, w, cin, cout, res, act):
    x = _rand(cuda, 15, 2, h, w, cin)
    wt = _rand(cuda, 16, 3, 3, cin, cout, scale=0.1)
    b = _rand(cuda, 17, cout)
    r = _rand(cuda, 18, 2, h, w, cout) if res else None
    got = fused_conv.conv3x3(x, wt, b, r, act, 0.2)
    ref = fused_conv.conv3x3_plain(x, wt, b, r, act, 0.2)
    _assert_close(got, ref, 1e-4)


def test_wrappers_raise_on_bad_input(cuda):
    x = _rand(cuda, 19, 1, 6, 7, 8)
    wt = _rand(cuda, 20, 3, 3, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv.conv3x3(x.transpose(1, 2), wt)
    with pytest.raises(ValueError, match="shape"):
        fused_conv.conv3x3(x, wt[:, :, :4].contiguous())
    with pytest.raises(RuntimeError, match="inference-only"):
        fused_conv.conv3x3(x.requires_grad_(), wt)


@pytest.mark.parametrize("cin,k_fused", [(1, False), (3, True)])
def test_small_model_gpu_matches_cpu(cuda, cin, k_fused):
    model = init_weights(FCVSRNet.small(in_channels=cin, k_fused=k_fused),
                         torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(21).uniform(
        0, 1, (1, 7, cin, 20, 28)).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert got.shape == (1, cin, 80, 112)
    assert float((got - ref).abs().max()) <= 1e-4
