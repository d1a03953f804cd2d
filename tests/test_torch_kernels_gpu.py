"""The port's CUDA kernels against their plain versions, on a GPU.

Skips without a CUDA device.  The machine with the card has no JAX, so run
these without the repository's conftest (which configures JAX):

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Shapes are small and odd: H and W not multiples of the tiles (IAC and its
adjoint 8x16, conv 8x16 / 16x16), channel counts not multiples of the
16-channel chunks, C_out 1 and 3; the DCN at frames smaller than its
128-pixel tile, Cin not a multiple of its 32-channel chunk, one deform group
wider than a chunk and C_out above its 64-channel block.  Tolerance: f32
against f32 in another summation order, 2e-5 (IAC), 1e-5 (its adjoint, whose
dsrc sums by atomics in an order that changes from run to run) and 1e-4
(convs, DCN) times max(1, max |plain|).  The small zoo models on the card
are held to the CPU at 1e-3, as chip_smoke.py holds the full ones.  The
training path's gradients (the autograd Functions and the model) are held
to their plain versions the same way, and the model's: the whole gradient
and the median tensor to 1e-3 of their norm, the per-tensor bar of the CPU test against JAX
(tests/test_torch_train.py), each tensor to 5e-2 (an activation within f32
noise of 0 flips on one device; chip_smoke.py says more).
"""

import numpy as np
import pytest
import torch

from fcvsr_tpu_torch.models import BACKBONES, FCVSRNet, build, init_weights
from fcvsr_tpu_torch.models.basicvsr import ModulatedDeformConv2d
from fcvsr_tpu_torch.ops import fused_conv, fused_dcn, fused_iac, launch_counts
from fcvsr_tpu_torch.ops.dcn import modulated_deform_conv2d
from fcvsr_tpu_torch.train.losses import charbonnier_sum

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


def _flows(dev, seed, b, h, w, scale):
    """Small flows, +-20 px in the top third, out of frame at the bottom and
    the left edge, as chip_smoke.py mixes them."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, h, w, 2)) * scale
    f[:, : max(1, h // 3)] = rng.uniform(-20, 20, (b, max(1, h // 3), w, 2))
    f[:, -max(1, h // 6):, :, 0] += 3 * w
    f[:, :, : max(1, w // 8), 1] -= 3 * h
    return torch.from_numpy(f.astype(np.float32)).to(dev)


@pytest.mark.parametrize("h,w,c,it", [
    (13, 29, 20, 0), (5, 7, 64, 2), (17, 33, 8, 1)])
def test_iac_bwd_kernel_matches_plain(cuda, h, w, c, it):
    b, n_it = 2, 3
    src = _rand(cuda, 30, b, h, w, c)
    flow = _flows(cuda, 31, b, h, w, 1.5)
    k = _rand(cuda, 32, b, h, w, n_it * 3 * c, scale=0.3)
    gz = _rand(cuda, 33, b, h, w, c)
    n0 = fused_iac.warp_sac_bwd.launches
    got = fused_iac.warp_sac_bwd(src, flow, k, gz, it)
    ref = fused_iac.warp_sac_vjp_plain(src, flow, k, gz, it)
    assert fused_iac.warp_sac_bwd.launches == n0 + 2
    for g, r in zip(got, ref):
        _assert_close(g, r, 1e-5)


@pytest.mark.parametrize("act_last", [True, False])
def test_iac_chain_grads_match_plain(cuda, act_last):
    """IACChainFn (forward and adjoint kernels) against autograd through the
    plain chain; launches: ac_num forward, 2 * ac_num adjoint."""
    b, h, w, c, ac = 2, 11, 19, 24, 3
    leaves = [_rand(cuda, 34, b, h, w, c),
              _rand(cuda, 35, b, h, w, ac * 3 * c, scale=0.3),
              torch.stack([_flows(cuda, 36 + i, b, h, w, 1.5)
                           for i in range(ac)])]
    leaves = [t.requires_grad_() for t in leaves]
    g = _rand(cuda, 40, b, h, w, c)
    before = launch_counts()
    out = fused_iac.iac_fused(*leaves, ac, c, act_last=act_last)
    got = torch.autograd.grad(out, leaves, g)
    after = launch_counts()
    assert after["iac"] - before["iac"] == ac
    assert after["iac_bwd"] - before["iac_bwd"] == 2 * ac
    cur = leaves[0]
    for i in range(ac):  # the plain chain under ordinary autograd
        cur = fused_iac.warp_sac_plain(cur, leaves[2][i], leaves[1], leaves[0],
                                       i < ac - 1 or act_last, i)
    ref = torch.autograd.grad(cur, leaves, g)
    _assert_close(out.detach(), cur.detach(), 2e-5)
    for a, r in zip(got, ref):
        _assert_close(a, r, 1e-4)


@pytest.mark.parametrize("h,w,cin,c1,cout,bias", [
    (9, 19, 64, 128, 64, True), (17, 5, 24, 40, 3, False)])
def test_conv_functions_grads_match_plain(cuda, h, w, cin, c1, cout, bias):
    """Conv3x3PairFn and Conv3x3Fn: kernel forwards, cuDNN VJPs; the pair's
    backward rebuilds its intermediate with one conv3x3 launch."""
    x = _rand(cuda, 41, 2, h, w, cin).requires_grad_()
    w1 = _rand(cuda, 42, 3, 3, cin, c1, scale=0.1).requires_grad_()
    w2 = _rand(cuda, 43, 3, 3, c1, cout, scale=0.1).requires_grad_()
    b1 = _rand(cuda, 44, c1).requires_grad_() if bias else None
    b2 = _rand(cuda, 45, cout).requires_grad_() if bias else None
    res = _rand(cuda, 46, 2, h, w, cout).requires_grad_()
    g = _rand(cuda, 47, 2, h, w, cout)
    ins = [t for t in (x, w1, b1, w2, b2) if t is not None]
    before = launch_counts()
    got = torch.autograd.grad(fused_conv.conv3x3_pair(x, w1, b1, w2, b2, 0.1),
                              ins, g)
    after = launch_counts()
    assert after["conv3x3_pair"] - before["conv3x3_pair"] == 1
    assert after["conv3x3"] - before["conv3x3"] == 1
    ref = torch.autograd.grad(
        fused_conv.conv3x3_pair_plain(x, w1, b1, w2, b2, 0.1), ins, g)
    for a, r in zip(got, ref):
        _assert_close(a, r, 1e-4)
    wt = _rand(cuda, 48, 3, 3, cin, cout, scale=0.1).requires_grad_()
    ins = [x, wt, res] + ([b2] if bias else [])
    got = torch.autograd.grad(
        fused_conv.conv3x3(x, wt, b2, res, True, 0.2), ins, g)
    ref = torch.autograd.grad(
        fused_conv.conv3x3_plain(x, wt, b2, res, True, 0.2), ins, g)
    for a, r in zip(got, ref):
        _assert_close(a, r, 1e-4)


@pytest.mark.parametrize("b,h,w,cin,cout,dg,with_mask", [
    (2, 13, 29, 24, 40, 3, True),    # odd frame, a chunk cut short
    (1, 5, 7, 8, 70, 1, True),       # a frame smaller than a tile, 2 co blocks
    (2, 9, 21, 64, 64, 8, False),    # DCNv1 (no mask), EDVR's layout
    (1, 12, 10, 128, 64, 16, True),  # BasicVSR++'s layout
    (1, 6, 11, 64, 20, 1, True),     # one group wider than a 32-channel chunk
])
def test_dcn_kernel_matches_plain(cuda, b, h, w, cin, cout, dg, with_mask):
    """Offsets small, +-20 px and out of the frame; the tolerance of the
    convs (sums of 9 x Cin products)."""
    x = _rand(cuda, 50, b, h, w, cin)
    off = torch.cat([_flows(cuda, 51 + i, b, h, w, 1.5) for i in range(9 * dg)],
                    -1)
    mask = torch.sigmoid(_rand(cuda, 52, b, h, w, 9 * dg)) if with_mask \
        else None
    wt = _rand(cuda, 53, 3, 3, cin, cout, scale=0.1)
    bias = _rand(cuda, 54, cout)
    n0 = fused_dcn.modulated_deform_conv2d_fused.launches
    got = fused_dcn.modulated_deform_conv2d_fused(x, off, mask, wt, bias,
                                                  deform_groups=dg)
    ref = modulated_deform_conv2d(x, off, mask, wt, bias, deform_groups=dg)
    assert fused_dcn.modulated_deform_conv2d_fused.launches == n0 + 1
    _assert_close(got, ref, 1e-4)


def test_dcn_kernel_raises_under_autograd_and_on_other_configs(cuda):
    x = _rand(cuda, 55, 1, 6, 7, 16)
    off = _rand(cuda, 56, 1, 6, 7, 2 * 18)
    mask = _rand(cuda, 57, 1, 6, 7, 2 * 9)
    wt = _rand(cuda, 58, 3, 3, 16, 8).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_dcn.modulated_deform_conv2d_fused(x, off, mask, wt,
                                                deform_groups=2)
    with torch.no_grad():
        fused_dcn.modulated_deform_conv2d_fused(x, off, mask, wt,
                                                deform_groups=2)
        with pytest.raises(ValueError, match="stride 1"):
            fused_dcn.modulated_deform_conv2d_fused(x, off, mask, wt,
                                                    stride=2, deform_groups=2)
        with pytest.raises(ValueError, match="does not divide"):
            fused_dcn.modulated_deform_conv2d_fused(x, off, mask, wt,
                                                    deform_groups=3)


@pytest.mark.parametrize("name", ["EDVRNet", "BasicVSRPlusPlus"])
def test_zoo_model_gpu_matches_cpu(cuda, name):
    """Small EDVR and BasicVSR++ with seeded non-zero offset convs: the GPU
    (DCN kernel) against the CPU (plain version); launches 4 a forward for
    EDVR, 4 * (T - 1) for BasicVSR++."""
    kw = dict(mid_channels=16, num_blocks_extraction=1,
              num_blocks_reconstruction=1) if name == "EDVRNet" \
        else dict(mid_channels=16, num_blocks=1)
    model = init_weights(build(BACKBONES, dict(type=name, **kw)),
                         torch.Generator().manual_seed(7)).eval()
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ModulatedDeformConv2d):
                last = [m for m in mod.conv_offset.modules()
                        if isinstance(m, torch.nn.Conv2d)][-1]
                last.weight.normal_(0, 0.02, generator=gen)
                last.bias.normal_(0, 3.0, generator=gen)
    t = 5 if name == "EDVRNet" else 4
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, (1, t, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        before = launch_counts()["dcn"]
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert launch_counts()["dcn"] - before == (4 if name == "EDVRNet"
                                               else 4 * (t - 1))
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-3


def test_wrappers_raise_on_bad_input(cuda):
    x = _rand(cuda, 19, 1, 6, 7, 8)
    wt = _rand(cuda, 20, 3, 3, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv.conv3x3(x.transpose(1, 2), wt)
    with pytest.raises(ValueError, match="shape"):
        fused_conv.conv3x3(x, wt[:, :, :4].contiguous())
    # a single launch records no autograd history: it refuses such inputs
    flow = _rand(cuda, 21, 1, 6, 7, 2)
    k = _rand(cuda, 22, 1, 6, 7, 24)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_iac.warp_sac_fused(x.requires_grad_(), flow, k, x)


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


@pytest.mark.parametrize("cin", [1, 3])
def test_small_model_gpu_grads_match_cpu(cuda, cin):
    """loss.backward() of FCVSR-S on the card (every kernel and its
    adjoint) against the CPU (plain versions), per parameter tensor."""
    model = init_weights(FCVSRNet.small(in_channels=cin, n_feats=32),
                         torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 7, cin, 20, 28))
                         .astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1, (2, cin, 80, 112))
                          .astype(np.float32))
    charbonnier_sum(model(x), gt).backward()
    ref = {k: p.grad.clone() for k, p in model.named_parameters()
           if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.to(cuda)
    before = launch_counts()
    charbonnier_sum(model(x.to(cuda)), gt.to(cuda)).backward()
    after = launch_counts()
    fcvsr_kernels = ("iac", "iac_bwd", "conv3x3_pair", "conv3x3")
    assert all(after[k] > before[k] for k in fcvsr_kernels), (before, after)
    assert after["dcn"] == before["dcn"]
    got = {k: p.grad for k, p in model.named_parameters()
           if p.grad is not None}
    assert got.keys() == ref.keys()
    rel = {k: float((got[k].cpu() - r).norm() / r.norm()) if r.any()
           else float(got[k].norm()) for k, r in ref.items()}
    whole = float(torch.cat([(got[k].cpu() - r).flatten() for k, r in
                             ref.items()]).norm()
                  / torch.cat([r.flatten() for r in ref.values()]).norm())
    # as chip_smoke.py bounds it: a (leaky) relu within f32 noise of 0 takes
    # the other branch on one device and moves the tensors behind it (one
    # conv-pair intermediate flipped here, 1.3e-3 to 1.9e-3 on one tensor);
    # a missing or wrong gradient is off by its own size
    assert whole <= 1e-3 and float(np.median(list(rel.values()))) <= 1e-3
    assert max(rel.values()) <= 5e-2, rel
