"""The custom ops of K1-K3 and the exported serving forward on the card.

    python -m pytest tests/test_torch_tools_gpu.py -q --noconftest

* Each custom op (``fcvsr::conv3x3``, ``fcvsr::conv3x3_pair``,
  ``fcvsr::iac_fused``) called on CUDA tensors at odd shapes that cut the
  kernels' tiles at the frame's edges equals its plain version at the
  kernel bars of tests/test_torch_kernels_gpu.py (1e-4 of max(1, |ref|)
  for the convs and the chain in float32, 1.6e-2 in bf16), and counts
  its launches: one a conv call, ``ac_num`` a chain.
* ``tools.export`` on the card: the program holds the three ops; loaded
  again, it launches K1, K2 and K3 as often as the eager forward and
  equals it within 1e-6 of max |out| (the same kernels on the same
  inputs).

No JAX here: the card's machine has none.
"""

import os

import numpy as np
import pytest
import torch

from fcvsr_tpu_torch.ops import (fused_conv, fused_iac, launch_counts,
                                 reset_launch_counts)
from fcvsr_tpu_torch.tools import export
from fcvsr_tpu_torch.utils.config import preset

pytestmark = pytest.mark.gpu

RTOL = 1e-4
BF16_RTOL = 1.6e-2
EXPORT_RTOL = 1e-6  # the loaded program against the eager forward


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


def _assert_close(got, ref, dtype):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    rtol = RTOL if dtype == torch.float32 else BF16_RTOL
    tol = rtol * max(1.0, float(ref.float().abs().max()))
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol, (err, tol)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,cin,cout,res,act", [
    (2, 13, 29, 8, 5, True, True), (1, 37, 50, 64, 64, True, False),
    (1, 3, 130, 24, 1, False, False)])
def test_conv3x3_op_matches_plain(cuda, dtype, b, h, w, cin, cout, res, act):
    x = _rand(cuda, 1, b, h, w, cin).to(dtype)
    wt = _rand(cuda, 2, 3, 3, cin, cout, scale=0.1)
    bias = _rand(cuda, 3, cout)
    r = _rand(cuda, 4, b, h, w, cout).to(dtype) if res else None
    n0 = fused_conv.conv3x3.launches
    got = fused_conv.conv3x3_op(x, wt, bias, r, act, 0.2)
    assert fused_conv.conv3x3.launches == n0 + 1
    _assert_close(got, fused_conv.conv3x3_plain(x, wt, bias, r, act, 0.2),
                  dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,cin,c1,cout,bias", [
    (2, 9, 65, 6, 24, 5, True), (1, 100, 130, 64, 128, 64, False),
    (2, 5, 7, 64, 64, 64, True)])
def test_conv3x3_pair_op_matches_plain(cuda, dtype, b, h, w, cin, c1, cout,
                                       bias):
    x = _rand(cuda, 5, b, h, w, cin).to(dtype)
    w1 = _rand(cuda, 6, 3, 3, cin, c1, scale=0.1)
    w2 = _rand(cuda, 7, 3, 3, c1, cout, scale=0.1)
    b1 = _rand(cuda, 8, c1) if bias else None
    b2 = _rand(cuda, 9, cout) if bias else None
    n0 = fused_conv.conv3x3_pair.launches
    got = fused_conv.conv3x3_pair_op(x, w1, b1, w2, b2, 0.1)
    assert fused_conv.conv3x3_pair.launches == n0 + 1
    _assert_close(got, fused_conv.conv3x3_pair_plain(x, w1, b1, w2, b2, 0.1),
                  dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,c,ac,act_last", [
    (2, 11, 19, 24, 3, True), (1, 37, 50, 64, 6, False),
    (1, 5, 7, 8, 2, True)])
def test_iac_fused_op_matches_plain(cuda, dtype, b, h, w, c, ac, act_last):
    fin = _rand(cuda, 10, b, h, w, c).to(dtype)
    k = _rand(cuda, 11, b, h, w, ac * 3 * c, scale=0.3).to(dtype)
    offs = _rand(cuda, 12, ac, b, h, w, 2, scale=1.5)
    n0 = fused_iac.warp_sac_fused.launches
    got = fused_iac.iac_fused_op(fin, k, offs, ac, act_last)
    assert fused_iac.warp_sac_fused.launches == n0 + ac
    _assert_close(got, fused_iac.iac_chain_plain(fin, k, offs, ac, act_last),
                  dtype)


def test_exported_program_launches_the_kernels(cuda, tmp_path):
    """FCVSR-S on Y at 20 x 28, exported and loaded on the card."""
    cfg = preset("fcvsr_s_cvcpLD_QP37")
    program, model = export.export_model(cfg, 20, 28, device=cuda)
    assert export.op_counts(program) == {"iac_fused": 6, "conv3x3_pair": 72,
                                         "conv3x3": 13}
    path = str(tmp_path / "s.pt2")
    torch.export.save(program, path)
    assert os.path.getsize(path) > 0
    loaded = torch.export.load(path).module()
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (1, 7, 1, 20, 28)).astype(np.float32)).to(cuda)
    with torch.no_grad():
        reset_launch_counts()
        ref = model(x)
        eager = launch_counts()
        reset_launch_counts()
        got = loaded(x)
        assert launch_counts() == eager
    assert eager["iac"] == 18 and eager["conv3x3_pair"] == 72 \
        and eager["conv3x3"] == 13
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    assert err <= EXPORT_RTOL * float(ref.abs().max()), err
