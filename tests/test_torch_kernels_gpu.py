"""The port's CUDA kernels against their plain versions, on a GPU.

Skips without a CUDA device.  The machine with the card has no JAX, so run
these without the repository's conftest (which configures JAX):

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Shapes are small and odd: H and W not multiples of the tiles (IAC 8x14,
its adjoint 8x16, the conv's row segments of 64 and 128 pixels), channel
counts not multiples of the 8- and 16-channel chunks, C_out 1 and 3; the conv pair (K2, on the tensor cores)
also with W past its 62-pixel segments, H past its row blocks, B 2, a
pixel stride that is not a multiple of 16 bytes, and in its one-pass
route, with its SASS holding wgmma; the DCN (K7, on wgmma) at frames
smaller than its 128-pixel tile (and its adjoint's 64), Cin and C_out not
multiples of 16, Cin not a multiple of its 64-channel chunk, one deform
group wider than 32 channels, C_out above its 64-channel block, a group
width of 3 (corners read as scalars) and of 4, and its adjoint (K8, one
launch a call on wgmma, C_out padded to 64 or 128) at those shapes and
with groups split across chunks, alone, under its autograd Function and
through the small zoo models' training gradients, with the SASS of both
holding wgmma.  Tolerance: f32
against f32 in another summation order, 2e-5 (IAC), 1e-5 (its adjoint, whose
dsrc sums by atomics in an order that changes from run to run) and 1e-4
(convs, DCN) times max(1, max |plain|); the DCN adjoint's five gradients
1e-4 times their own max (its dW sums over every pixel and its dx by
atomics).  The small zoo models on the card
are held to the CPU at 1e-3, as chip_smoke.py holds the full ones.  The
training path's gradients (the autograd Functions and the model) are held
to their plain versions the same way, and the model's: the whole gradient
and the median tensor to 1e-3 of their norm, the per-tensor bar of the CPU test against JAX
(tests/test_torch_train.py), each tensor to 5e-2 (an activation within f32
noise of 0 flips on one device; chip_smoke.py says more).

K1 (8x14 tiles, 8-channel blocks, the kf prediction on mma.sync) and K3
(the one-conv case of K2's wgmma loop, 64- and 128-pixel segments, Cout
tiles of 64) also at the edges of their tiles, float32 and bf16 maps,
with their SASS holding tensor-core instructions.

The serving kernels of the --fast path: the resident IAC chain (K4, one
cooperative launch of K1's tile body) and the BlockRCB quad (K6, two of
K2's loops in one persistent cooperative launch, also where its work
items outnumber the co-resident grid), in float32 and bf16 storage, and
K1-K3 in bf16, against their plain versions; K4 also bit for bit against
K1 launched once an iteration.  Float32 bars as above (1e-4 for the
chain, carried through its iterations), bf16 two bf16 steps of the
output's magnitude (1.6e-2), since the two versions round at the same
handoffs but a value within reassociation noise of a rounding boundary
rounds either way.  FCVSR-S under the serving flags on the card
against the CPU, with its launches, and wholly in bf16 (its K1, K2 and K3
on bf16 maps, the kernels handed bf16 weights equal to the same launches
on float32 copies, bit for bit).  TDAN's DCNv1 (no mask, no bias, 8
deform groups) through K7 and K8 at its training batch and at odd frames;
the small BasicVSR, IconVSR and TDAN on the card against the CPU, with
their DCN launches, and IconVSR's and TDAN's gradients.

The BlockRCB level (K11: K6's two wgmma phases and the ContextBlock in
one cooperative launch, bf16 maps) against its plain version at the bf16
bar, at H and W below and not multiples of K2's 62-pixel segments, C1 =
C and 2C, B 1 and 2; its y and r bit for bit against a K6 launch on
bf16-rounded weights, also with more work items than the grid holds; C
above 64 and C1 above 128 refused, and wgmma in its SASS.  The IAC
adjoint (K5) is one launch a call, also at C 5 (scalar loads and
atomics) and with flows far outside the frame.  The toolchain probe's
kernel (K12), exact.  Every launch enters its tensors' device: K1, K2, K7, K8 and K11 on
cuda:1 with cuda:0 current (skips below two cards), and K2 and K11
launched from a side stream, complete once that stream alone is
synchronised, as are K4 and K6.  A DDP step of FCVSR-S at world size 1 on
NCCL takes the plain step's loss and update, through the kernels.
"""

import numpy as np
import pytest
import torch

from fcvsr_tpu_torch import cli
from fcvsr_tpu_torch.models import (BACKBONES, FCVSRNet, build,
                                    fcvsr_etc_forward, init_weights, tiled_sr)
from fcvsr_tpu_torch.models.basicvsr import ModulatedDeformConv2d
from fcvsr_tpu_torch.ops import fused_conv, fused_dcn, fused_iac, launch_counts
from fcvsr_tpu_torch.ops.dcn import (modulated_deform_conv2d,
                                     modulated_deform_conv2d_vjp)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,c1,cout", [
    (1, 100, 130, 64, 128, 64),  # W past 2 segments of 62; rows a block 3, the last 1
    (2, 5, 7, 64, 64, 64),       # H and W below one segment, B 2
    (2, 9, 65, 6, 24, 5),        # pixel stride 24 (12) bytes: element loads
    (1, 301, 40, 32, 128, 64),   # one segment, 101 blocks of 3 rows, the last 1
])
def test_pair_tc_kernel_edges(cuda, dtype, b, h, w, cin, c1, cout):
    """K2 on the tensor cores at the edges of its row segments and row
    blocks (a block takes as many rows as fill the card once: on 132 SMs
    the row counts above), float32 (bf16x3) and bf16 maps, against the
    plain version."""
    x = _rand(cuda, 100, b, h, w, cin).to(dtype)
    w1 = _rand(cuda, 101, 3, 3, cin, c1, scale=0.1)
    w2 = _rand(cuda, 102, 3, 3, c1, cout, scale=0.1)
    b1 = _rand(cuda, 103, c1)
    b2 = _rand(cuda, 104, cout)
    n0 = fused_conv.conv3x3_pair.launches
    got = fused_conv.conv3x3_pair(x, w1, b1, w2, b2, 0.1)
    assert fused_conv.conv3x3_pair.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (b, h, w, cout)
    _assert_close_as(got, fused_conv.conv3x3_pair_plain(x, w1, b1, w2, b2, 0.1),
                     1e-4)


def test_pair_kernel_refuses_wide_channels(cuda):
    x = _rand(cuda, 110, 1, 4, 5, 72)
    wide = _rand(cuda, 111, 3, 3, 72, 8)
    narrow = _rand(cuda, 112, 3, 3, 8, 8)
    with pytest.raises(ValueError, match="up to"):
        fused_conv.conv3x3_pair(x, wide, None, narrow, None)


# K2's kernel issues wgmma (HGMMA in SASS); its float32 work outside them
# is the epilogue's bias, activation and splits (FADD, FMUL).  The FMA
# kernel it replaced ran its main loop as FFMA on register tiles
SASS_FFMA_MAX = 32
# K7's and K8's FFMA: the sampler's bilinear sums and the adjoint's
# derivatives, unrolled over a quad's 4 channels (chip_smoke.py's bar)
DCN_SASS_FFMA_MAX = 160


def test_pair_kernel_runs_on_the_tensor_cores(cuda):
    """The SASS of every conv3x3_pair_kernel (K2) and conv3x3_quad_kernel
    (K6, two of K2's loops) in the main library holds HGMMA and no FFMA
    main loop (chip_smoke.py checks the same)."""
    from fcvsr_tpu_torch.ops import _native

    for kernel in ("conv3x3_pair_kernel", "conv3x3_quad_kernel"):
        counts = _native.sass_ops(_native.lib()._name, kernel,
                                  ("HGMMA", "FFMA", "HMMA"))
        if counts is None:
            pytest.skip("the toolkit has no cuobjdump")
        assert counts, f"no {kernel} in the library"
        for name, ops in counts.items():
            assert ops["HGMMA"] > 0 and ops["FFMA"] <= SASS_FFMA_MAX, \
                (name, ops)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kf", [False, True])
@pytest.mark.parametrize("b,h,w,c,c0,flow_scale", [
    (2, 8, 29, 20, 5, 400.0),    # H one tile, W past 2 tiles of 14, C % 8 4
    (2, 9, 15, 12, 24, 2.0),     # H < tile + 2, W one column past a tile
    (1, 17, 28, 64, 64, 25.0),   # FCVSR's C and C0, H past 2 tiles
    (1, 3, 5, 7, 16, 1.5),       # a frame smaller than a tile, C odd
])
def test_iac_tile_edges(cuda, dtype, kf, b, h, w, c, c0, flow_scale):
    """K1 at the edges of its 8x14 tiles and its 8-channel blocks, both
    modes (the kf prediction on the tensor cores), float32 and bf16 maps,
    flows up to 400 px (out of the frame), against the plain version."""
    feat = _rand(cuda, 120, b, h, w, c).to(dtype)
    fin = _rand(cuda, 121, b, h, w, c).to(dtype)
    flow = _rand(cuda, 122, b, h, w, 2, scale=flow_scale)
    k = _rand(cuda, 123, b, h, w, 2 * 3 * c, scale=0.3).to(dtype)
    f0 = _rand(cuda, 124, b, h, w, c0).to(dtype)
    wsel = _rand(cuda, 125, c0, 2 * 3 * c, scale=0.2)
    bsel = _rand(cuda, 126, 2 * 3 * c, scale=0.1)
    for it, act in ((0, True), (1, False)):
        if kf:
            got = fused_iac.warp_sac_fused_kf(feat, flow, f0, wsel, bsel, fin,
                                              act, it)
            ref = fused_iac.warp_sac_plain(
                feat, flow, fused_iac.predict_kernels(f0, wsel, bsel, it, c),
                fin, act)
        else:
            got = fused_iac.warp_sac_fused(feat, flow, k, fin, act, it)
            ref = fused_iac.warp_sac_plain(feat, flow, k, fin, act, it)
        assert got.dtype == dtype and got.shape == fin.shape
        _assert_close_as(got, ref, 2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout,res,act", [
    (1, 5, 130, 64, 64, True, False),   # W past 2 segments of 64
    (2, 3, 7, 64, 1, False, False),     # H below a block's rows, Cout 1
    (1, 40, 200, 64, 3, True, True),    # segments of 128 cut at W, Cout 3
    (1, 301, 70, 24, 70, True, True),   # 2 Cout tiles; pixel stride 96 (48) B
    (2, 9, 65, 6, 5, False, True),      # stride 24 (12) bytes: element loads
])
def test_conv_tc_kernel_edges(cuda, dtype, b, h, w, cin, cout, res, act):
    """K3 on the tensor cores at the edges of its row segments (64 pixels,
    128 for Cout <= 8), its row blocks and its Cout tiles of 64, with and
    without residual and activation, float32 (bf16x3) and bf16 maps."""
    x = _rand(cuda, 130, b, h, w, cin).to(dtype)
    wt = _rand(cuda, 131, 3, 3, cin, cout, scale=0.1)
    bias = _rand(cuda, 132, cout)
    r = _rand(cuda, 133, b, h, w, cout).to(dtype) if res else None
    n0 = fused_conv.conv3x3.launches
    got = fused_conv.conv3x3(x, wt, bias, r, act, 0.2)
    assert fused_conv.conv3x3.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (b, h, w, cout)
    _assert_close_as(got, fused_conv.conv3x3_plain(x, wt, bias, r, act, 0.2),
                     1e-4)


def test_tc_kernels_refuse_what_they_do_not_take(cuda):
    """K3 takes Cin up to 64; K1 and K4 C up to 128 and K1 C0 up to 64; K6
    each pair's channels as K2 does."""
    x = _rand(cuda, 140, 1, 4, 5, 72)
    with pytest.raises(ValueError, match="up to"):
        fused_conv.conv3x3(x, _rand(cuda, 141, 3, 3, 72, 8))
    feat = _rand(cuda, 142, 1, 4, 5, 8)
    flow = _rand(cuda, 143, 1, 4, 5, 2)
    f0 = _rand(cuda, 144, 1, 4, 5, 80)
    with pytest.raises(ValueError, match="up to"):
        fused_iac.warp_sac_fused_kf(feat, flow, f0, _rand(cuda, 145, 80, 24),
                                    _rand(cuda, 146, 24), feat)
    wide = _rand(cuda, 147, 1, 4, 5, 136)
    with pytest.raises(ValueError, match="up to"):
        fused_iac.warp_sac_fused(wide, flow, _rand(cuda, 148, 1, 4, 5, 408),
                                 wide)
    with pytest.raises(ValueError, match="up to"):
        fused_iac.iac_fused_resident(wide, _rand(cuda, 149, 1, 4, 5, 408),
                                     flow[None], 1)
    x8 = _rand(cuda, 150, 1, 4, 5, 8)
    w8, w8_wide = _rand(cuda, 151, 3, 3, 8, 8), _rand(cuda, 152, 3, 3, 8, 72)
    with pytest.raises(ValueError, match="up to"):  # y (C2) 72 wide
        fused_conv.conv3x3_quad(x8, w8, None, w8_wide, None,
                                _rand(cuda, 153, 3, 3, 72, 8), None, w8, None)


def test_iac_and_conv_kernels_run_on_the_tensor_cores(cuda):
    """The SASS of K1's kf kernels holds mma.sync (HMMA), and of K3's
    kernels wgmma (HGMMA) with at most SASS_FFMA_MAX FFMA (chip_smoke.py
    checks the same)."""
    from fcvsr_tpu_torch.ops import _native

    path = _native.lib()._name
    iac = _native.sass_ops(path, "iac_kernel", ("HMMA", "FFMA"))
    one = _native.sass_ops(path, "conv3x3_one", ("HGMMA", "FFMA"))
    if iac is None:
        pytest.skip("the toolkit has no cuobjdump")
    kf = {n: ops for n, ops in iac.items() if "Lb1E" in n}
    assert len(kf) == 2 and len(one) == 4, (iac, one)
    for name, ops in kf.items():
        assert ops["HMMA"] > 0, (name, ops)
    for name, ops in one.items():
        assert ops["HGMMA"] > 0 and ops["FFMA"] <= SASS_FFMA_MAX, (name, ops)


def _flows(dev, seed, b, h, w, scale):
    """Small flows, +-20 px in the top third, out of frame at the bottom and
    the left edge, as chip_smoke.py mixes them."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, h, w, 2)) * scale
    f[:, : max(1, h // 3)] = rng.uniform(-20, 20, (b, max(1, h // 3), w, 2))
    f[:, -max(1, h // 6):, :, 0] += 3 * w
    f[:, :, : max(1, w // 8), 1] -= 3 * h
    return torch.from_numpy(f.astype(np.float32)).to(dev)


@pytest.mark.parametrize("b,h,w,c,it,far", [
    (2, 13, 29, 20, 0, False), (2, 5, 7, 64, 2, False),
    (2, 17, 33, 8, 1, False),
    (2, 9, 21, 5, 1, False),    # C 5: no quads, scalar loads and atomics
    (3, 11, 18, 24, 2, True)])  # flows far outside the frame at every pixel
def test_iac_bwd_kernel_matches_plain(cuda, b, h, w, c, it, far):
    """K5, one launch a call, against the plain adjoint at 1e-5: tiles cut
    at the frame's edges, channel chunks cut short, C not a multiple of 4,
    and (``far``) four in five pixels' flows pushed 5 frames' size out, in
    one of four directions, where the clamp holds every corner outside the
    frame: dsrc and dflow take nothing from them."""
    n_it = 3
    src = _rand(cuda, 30, b, h, w, c)
    flow = _flows(cuda, 31, b, h, w, 1.5)
    if far:
        side = torch.from_numpy(np.random.default_rng(37).integers(
            0, 5, (b, h, w))).to(cuda)
        for i, (dx, dy) in enumerate(((5 * w, 0), (-5 * w, 0), (0, 5 * h),
                                      (0, -5 * h))):
            flow[..., 0] += (side == i) * dx
            flow[..., 1] += (side == i) * dy
    k = _rand(cuda, 32, b, h, w, n_it * 3 * c, scale=0.3)
    gz = _rand(cuda, 33, b, h, w, c)
    n0 = fused_iac.warp_sac_bwd.launches
    got = fused_iac.warp_sac_bwd(src, flow, k, gz, it)
    ref = fused_iac.warp_sac_vjp_plain(src, flow, k, gz, it)
    assert fused_iac.warp_sac_bwd.launches == n0 + 1
    for g, r in zip(got, ref):
        _assert_close(g, r, 1e-5)


@pytest.mark.parametrize("act_last", [True, False])
def test_iac_chain_grads_match_plain(cuda, act_last):
    """IACChainFn (forward and adjoint kernels) against autograd through the
    plain chain; launches: ac_num forward, ac_num adjoint."""
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
    assert after["iac_bwd"] - before["iac_bwd"] == ac
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
    (1, 6, 11, 64, 20, 1, True),     # one group wider than 32 channels
    (2, 9, 11, 6, 20, 2, True),      # a group width of 3: scalar corners
    (1, 7, 6, 32, 12, 8, True),      # a group width of 4, 42 pixels
    (2, 10, 13, 96, 72, 4, False),   # Cin across two chunks, 2 co blocks
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
    """Under autograd the wrapper runs DCNFn (one forward launch, no
    refusal); a configuration the kernels do not take raises, with or
    without autograd, and so does a deform group count not dividing Cin."""
    x = _rand(cuda, 55, 1, 6, 7, 16)
    off = _rand(cuda, 56, 1, 6, 7, 2 * 18)
    mask = _rand(cuda, 57, 1, 6, 7, 2 * 9)
    wt = _rand(cuda, 58, 3, 3, 16, 8).requires_grad_()
    n0 = fused_dcn.modulated_deform_conv2d_fused.launches
    out = fused_dcn.modulated_deform_conv2d_fused(x, off, mask, wt,
                                                  deform_groups=2)
    assert out.grad_fn is not None
    assert fused_dcn.modulated_deform_conv2d_fused.launches == n0 + 1
    with pytest.raises(ValueError, match="stride 1"):
        fused_dcn.modulated_deform_conv2d_fused(x, off, mask, wt, stride=2,
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


def test_dcn_kernels_run_on_the_tensor_cores(cuda):
    """The SASS of K7's kernel and K8's two (Cout padded to 64 and 128)
    holds HGMMA; their FFMA are the sampler's and the derivatives', no
    contraction (chip_smoke.py checks the same)."""
    from fcvsr_tpu_torch.ops import _native

    counts = _native.sass_ops(_native.lib()._name, "dcn_", ("HGMMA", "FFMA"))
    if counts is None:
        pytest.skip("the toolkit has no cuobjdump")
    assert len(counts) == 3, counts
    for name, ops in counts.items():
        assert ops["HGMMA"] > 0 and ops["FFMA"] <= DCN_SASS_FFMA_MAX, \
            (name, ops)


def test_dcn_adjoint_raises_beyond_its_cout(cuda):
    """K8 holds g's tile and its weight slice, Cout padded to 64 or 128,
    in shared memory: a wider Cout raises before any launch."""
    x, off, mask, wt, bb, g = _dcn_case(cuda, 80, 1, 5, 6, 8, 130, 1, True)
    n0 = fused_dcn.modulated_deform_conv2d_fused_vjp.launches
    with pytest.raises(ValueError, match="Cout <= 128"):
        fused_dcn.modulated_deform_conv2d_fused_vjp(x, off, mask, wt, bb, g,
                                                    deform_groups=1)
    assert fused_dcn.modulated_deform_conv2d_fused_vjp.launches == n0


def _dcn_case(dev, seed, b, h, w, cin, cout, dg, with_mask, bias=True):
    x = _rand(dev, seed, b, h, w, cin)
    off = torch.cat([_flows(dev, seed + 1 + i, b, h, w, 1.5)
                     for i in range(9 * dg)], -1)
    mask = torch.sigmoid(_rand(dev, seed + 2, b, h, w, 9 * dg)) \
        if with_mask else None
    wt = _rand(dev, seed + 3, 3, 3, cin, cout, scale=1 / np.sqrt(9 * cin))
    bb = _rand(dev, seed + 4, cout) if bias else None
    g = _rand(dev, seed + 5, b, h, w, cout)
    return x, off, mask, wt, bb, g


def _assert_grads_close(got, ref, rtol):
    """Each gradient within rtol of its own max: the weight gradient sums
    over every pixel, dx by atomics in an order that changes from run to
    run."""
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        assert (a is None) == (r is None)
        if r is not None:
            err = float((a - r).abs().max())
            assert err <= rtol * max(1e-6, float(r.abs().max())), (err, r.shape)


@pytest.mark.parametrize("b,h,w,cin,cout,dg,with_mask,bias", [
    (2, 13, 29, 24, 40, 3, True, True),    # odd frame, a chunk cut short
    (1, 5, 7, 8, 70, 1, True, False),      # smaller than a tile, 2 co blocks
    (2, 9, 21, 64, 64, 8, False, True),    # DCNv1 (no mask), EDVR's layout
    (1, 12, 10, 128, 64, 16, True, True),  # BasicVSR++'s layout
    (1, 6, 11, 64, 20, 1, True, True),     # one group wider than a chunk
    (3, 17, 19, 48, 24, 2, True, True),    # 24-channel groups across chunks
    (2, 9, 11, 6, 20, 2, True, True),      # a group width of 3: scalar
    (1, 7, 6, 32, 12, 8, True, False),     # a group width of 4, 42 pixels
    (2, 10, 13, 96, 100, 4, False, True),  # Cin across chunks, Cout 100
])
def test_dcn_bwd_kernel_matches_plain(cuda, b, h, w, cin, cout, dg,
                                      with_mask, bias):
    """K8 (one launch a call) against the plain VJP, offsets small, +-20
    px and out of the frame."""
    x, off, mask, wt, bb, g = _dcn_case(cuda, 60, b, h, w, cin, cout, dg,
                                        with_mask, bias)
    n0 = fused_dcn.modulated_deform_conv2d_fused_vjp.launches
    got = fused_dcn.modulated_deform_conv2d_fused_vjp(x, off, mask, wt, bb, g,
                                                      deform_groups=dg)
    assert fused_dcn.modulated_deform_conv2d_fused_vjp.launches == n0 + 1
    ref = modulated_deform_conv2d_vjp(x, off, mask, wt, bb, g, dg)
    _assert_grads_close(got, ref, 1e-4)


@pytest.mark.parametrize("with_mask", [True, False])
def test_dcn_function_grads_match_plain(cuda, with_mask):
    """DCNFn under autograd: one K7 launch forward, one K8 launch
    backward, the gradients of autograd through the plain forward."""
    x, off, mask, wt, bb, g = _dcn_case(cuda, 70, 2, 11, 15, 32, 24, 4,
                                        with_mask)
    leaves = [t.requires_grad_() for t in (x, off, mask, wt, bb)
              if t is not None]
    before = launch_counts()
    out = fused_dcn.modulated_deform_conv2d_fused(x, off, mask, wt, bb,
                                                  deform_groups=4)
    got = torch.autograd.grad(out, leaves, g)
    after = launch_counts()
    assert after["dcn"] - before["dcn"] == 1
    assert after["dcn_bwd"] - before["dcn_bwd"] == 1
    ref = torch.autograd.grad(
        modulated_deform_conv2d(x, off, mask, wt, bb, deform_groups=4),
        leaves, g)
    _assert_grads_close(got, ref, 1e-4)


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


@pytest.mark.parametrize("name", ["EDVRNet", "BasicVSRPlusPlus"])
def test_zoo_model_gpu_grads_match_cpu(cuda, name):
    """Small EDVR and BasicVSR++ trained one step's gradient on the card (K7
    forward, K8 backward: 1 adjoint launch a DCN) against the CPU: the
    whole gradient and the median tensor within 1e-3 of their norm, each
    tensor of the DCNs (their weights and offset convs) within 5e-2 (a
    sample point or a relu input within f32 noise of its branch moves the
    tensors behind it).  Elsewhere, at 16 channels, one max-pool window
    of EDVR's TSA fusion whose two largest values lie within f32 noise of
    each other moves a small tensor by more (fusion.spatial_attn1 went past
    5e-2 once)."""
    from fcvsr_tpu_torch.models import VideoRestorer

    kw = dict(mid_channels=16, num_blocks_extraction=1,
              num_blocks_reconstruction=1) if name == "EDVRNet" \
        else dict(mid_channels=16, num_blocks=1)
    model = init_weights(build(BACKBONES, dict(type=name, **kw)),
                         torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ModulatedDeformConv2d):
                last = [m for m in mod.conv_offset.modules()
                        if isinstance(m, torch.nn.Conv2d)][-1]
                last.weight.normal_(0, 0.02, generator=gen)
                last.bias.normal_(0, 3.0, generator=gen)
    t = 5 if name == "EDVRNet" else 4
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.uniform(0, 1, (1, t, 3, 64, 64))
                         .astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1, (1, t, 3, 256, 256))
                          .astype(np.float32))
    restorer = VideoRestorer(model, center_frame_only=name == "EDVRNet")
    restorer.loss_fn(x, gt)[0].backward()
    ref = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.to(cuda)
    before = launch_counts()
    restorer.loss_fn(x.to(cuda), gt.to(cuda))[0].backward()
    after = launch_counts()
    n = 4 if name == "EDVRNet" else 4 * (t - 1)
    assert after["dcn"] - before["dcn"] == n
    assert after["dcn_bwd"] - before["dcn_bwd"] == n
    got = {k: p.grad.cpu() for k, p in model.named_parameters()}
    rel = {k: float((got[k] - r).norm() / r.norm()) for k, r in ref.items()}
    whole = float(torch.cat([(got[k] - r).flatten() for k, r in
                             ref.items()]).norm()
                  / torch.cat([r.flatten() for r in ref.values()]).norm())
    assert whole <= 1e-3 and float(np.median(list(rel.values()))) <= 1e-3
    dcn = {k: v for k, v in rel.items()
           if "dcn" in k or "deform_align" in k}
    assert dcn and max(dcn.values()) <= 5e-2, max(dcn.items(),
                                                  key=lambda kv: kv[1])


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


def test_ddp_step_at_world_size_one_equals_the_plain_step(cuda):
    """One Adam step of FCVSR-S under DDP at world size 1 on NCCL
    (``make_train_step(group=...)``: the parameter broadcast, the gradient
    buckets and their all-reduce) against the plain step on the card: the
    same loss bit for bit (the forward's kernels are deterministic), the
    same update within 1e-3 of its norm (the IAC adjoint sums by atomics,
    and Adam's first step divides each gradient by its own magnitude), and
    the FCVSR kernels launched under DDP."""
    import socket

    import torch.distributed as dist

    from fcvsr_tpu_torch.parallel import initialize_multihost, shutdown
    from fcvsr_tpu_torch.train.trainer import TrainState, make_train_step

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 7, 1, 20, 28))
                         .astype(np.float32)).to(cuda)
    gt = torch.from_numpy(rng.uniform(0, 1, (2, 1, 80, 112))
                          .astype(np.float32)).to(cuda)

    def one_step(group):
        model = init_weights(FCVSRNet.small(n_feats=32),
                             torch.Generator().manual_seed(5)).to(cuda)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = TrainState(model, lambda s: 1e-4)
        loss = make_train_step(state, "charbonnier_sum", group=group)(x, gt)
        return float(loss["loss"]), {k: p.detach() - before[k] for k, p in
                                     model.named_parameters()}

    loss, update = one_step(None)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        counts = launch_counts()
        ddp_loss, ddp_update = one_step(dist.group.WORLD)
        moved = {k: v - counts[k] for k, v in launch_counts().items()}
    finally:
        shutdown()
    assert ddp_loss == loss
    assert all(moved[k] > 0 for k in ("iac", "iac_bwd", "conv3x3_pair",
                                      "conv3x3")), moved
    num = sum(float((ddp_update[k] - u).norm() ** 2)
              for k, u in update.items())
    den = sum(float(u.norm() ** 2) for u in update.values())
    assert (num / den) ** 0.5 <= 1e-3, (num / den) ** 0.5


# bf16 storage: the kernels and the plain versions round at the same
# handoffs, so they differ where a float32 value within reassociation noise
# of a rounding boundary rounds the other way, one bf16 step (2^-8 to 2^-7
# of the value) that later iterations or convs carry on: two steps of the
# output's magnitude
BF16_RTOL = 1.6e-2
# the resident chain against the plain chain in float32: the 2e-5 of one
# iteration, carried through up to 6
CHAIN_RTOL = 1e-4


def _bf16(t):
    return t.to(torch.bfloat16)


def _assert_close_as(got, ref, rtol_f32):
    """``got`` against ``ref`` in float32 at ``rtol_f32`` for float32
    storage, at BF16_RTOL for bf16; both of the same storage type."""
    assert got.dtype == ref.dtype
    rtol = rtol_f32 if got.dtype == torch.float32 else BF16_RTOL
    _assert_close(got.float(), ref.float(), rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,c,ac,act_last", [
    (2, 13, 29, 20, 3, True), (1, 5, 7, 64, 6, False), (2, 40, 33, 16, 2, True),
    (1, 9, 17, 8, 1, False)])
def test_iac_chain_kernel_matches_plain(cuda, dtype, b, h, w, c, ac, act_last):
    """K4, the whole chain in one cooperative launch, against the plain
    chain, and bit for bit against K1 launched once an iteration (both run
    K1's tile body on the same values), with flows beyond +-20 px and out
    of the frame; B 1 and 2, tiles cut at the frame's edges, channel
    blocks cut short."""
    fin = _rand(cuda, 50, b, h, w, c).to(dtype)
    k = _rand(cuda, 51, b, h, w, ac * 3 * c, scale=0.3).to(dtype)
    offs = torch.stack([_flows(cuda, 52 + i, b, h, w, 1.5) for i in range(ac)])
    before = launch_counts()
    got = fused_iac.iac_fused_resident(fin, k, offs, ac, act_last)
    mid = launch_counts()
    assert mid["iac_chain"] - before["iac_chain"] == 1 and \
        mid["iac"] == before["iac"]
    assert got.dtype == dtype and got.shape == fin.shape
    _assert_close_as(got, fused_iac.iac_chain_plain(fin, k, offs, ac, act_last),
                     CHAIN_RTOL)
    periter = fused_iac.iac_fused(fin, k, offs, ac, c, act_last)
    assert launch_counts()["iac"] - mid["iac"] == ac
    torch.cuda.synchronize()
    assert torch.equal(got, periter), \
        float((got.float() - periter.float()).abs().max())


@pytest.mark.parametrize("h,w,c", [(13, 29, 20), (5, 7, 64)])
def test_iac_kernels_bf16_match_plain(cuda, h, w, c):
    """K1's bf16 variants, materialised and fused kernel prediction."""
    b, n_it, c0 = 2, 2, 24
    feat = _bf16(_rand(cuda, 60, b, h, w, c))
    fin = _bf16(_rand(cuda, 61, b, h, w, c))
    flow = _flows(cuda, 62, b, h, w, 1.5)
    k = _bf16(_rand(cuda, 63, b, h, w, n_it * 3 * c, scale=0.3))
    f0 = _bf16(_rand(cuda, 64, b, h, w, c0))
    wsel = _rand(cuda, 65, c0, n_it * 3 * c, scale=0.2)
    bsel = _rand(cuda, 66, n_it * 3 * c, scale=0.1)
    for it in range(n_it):
        _assert_close_as(fused_iac.warp_sac_fused(feat, flow, k, fin, True, it),
                         fused_iac.warp_sac_plain(feat, flow, k, fin, True, it),
                         2e-5)
        got = fused_iac.warp_sac_fused_kf(feat, flow, f0, wsel, bsel, fin,
                                          False, it)
        ref = fused_iac.warp_sac_plain(
            feat, flow, fused_iac.predict_kernels(f0, wsel, bsel, it, c), fin,
            False)
        _assert_close_as(got, ref, 2e-5)


@pytest.mark.parametrize("h,w,cin,c1,cout,bias", [
    (9, 19, 64, 128, 64, True), (17, 5, 24, 40, 3, False)])
def test_conv_kernels_bf16_match_plain(cuda, h, w, cin, c1, cout, bias):
    """K2 and K3 with bf16 maps (float32 weights and biases)."""
    x = _bf16(_rand(cuda, 70, 2, h, w, cin))
    w1 = _rand(cuda, 71, 3, 3, cin, c1, scale=0.1)
    w2 = _rand(cuda, 72, 3, 3, c1, cout, scale=0.1)
    b1 = _rand(cuda, 73, c1) if bias else None
    b2 = _rand(cuda, 74, cout) if bias else None
    _assert_close_as(fused_conv.conv3x3_pair(x, w1, b1, w2, b2, 0.1),
                     fused_conv.conv3x3_pair_plain(x, w1, b1, w2, b2, 0.1),
                     1e-4)
    wt = _rand(cuda, 75, 3, 3, cin, cout, scale=0.1)
    res = _bf16(_rand(cuda, 76, 2, h, w, cout))
    _assert_close_as(fused_conv.conv3x3(x, wt, b2, res, True, 0.2),
                     fused_conv.conv3x3_plain(x, wt, b2, res, True, 0.2), 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,chans,bias", [
    (2, 5, 7, (64, 128, 64, 64, 64), True),     # H and W below one tile
    (1, 37, 50, (64, 128, 64, 64, 64), False),  # tiles cut at both edges
    (2, 19, 21, (16, 40, 24, 20, 12), True),    # chunks cut short
    (1, 1, 33, (8, 16, 8, 8, 3), False),
    # 46 segments x 3 images: more work items than the card holds blocks
    (3, 9, 2800, (64, 128, 64, 64, 64), True)])
def test_quad_kernel_matches_plain(cuda, dtype, b, h, w, chans, bias):
    """K6 against its plain version (two plain pairs) and against two K2
    launches; y and out both.  Its persistent blocks loop over K2's work
    items (62-pixel segments x row blocks x images); at 3 x 9 x 2800 the
    items outnumber the co-resident grid (138 against one block an SM)."""
    c, c1, c2, c3, cout = chans
    x = _rand(cuda, 80, b, h, w, c).to(dtype)
    ws = [_rand(cuda, 81 + i, 3, 3, ci, co, scale=0.1)
          for i, (ci, co) in enumerate(zip(chans, chans[1:]))]
    bs = [_rand(cuda, 85 + i, co, scale=0.1) if bias or i < 2 else None
          for i, co in enumerate(chans[1:])]
    args = [t for pair in zip(ws, bs) for t in pair]
    before = launch_counts()
    y, out = fused_conv.conv3x3_quad(x, *args)
    after = launch_counts()
    assert after["conv3x3_quad"] - before["conv3x3_quad"] == 1
    assert after["conv3x3_pair"] == before["conv3x3_pair"]
    assert y.shape == (b, h, w, c2) and out.shape == (b, h, w, cout)
    y_ref, out_ref = fused_conv.conv3x3_quad_plain(x, *args)
    _assert_close_as(y, y_ref, 1e-4)
    _assert_close_as(out, out_ref, 1e-4)
    y2 = fused_conv.conv3x3_pair(x, *args[:4], 0.1)
    _assert_close_as(y, y2, 1e-4)
    _assert_close_as(out, fused_conv.conv3x3_pair(y2, *args[4:], 0.2), 1e-4)


def test_serving_kernels_raise_under_autograd(cuda):
    """K4, K6 and bf16 storage have no backward: on the card they refuse
    inputs that autograd records, where the plain versions would train."""
    x = _rand(cuda, 90, 1, 6, 7, 8).requires_grad_()
    wt = _rand(cuda, 91, 3, 3, 8, 8)
    with pytest.raises(RuntimeError, match="serving kernel"):
        fused_conv.conv3x3_quad(x, wt, None, wt, None, wt, None, wt, None)
    k = _rand(cuda, 92, 1, 6, 7, 24)
    offs = _rand(cuda, 93, 1, 1, 6, 7, 2)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_iac.iac_fused_resident(x, k, offs, 1)
    xb = _bf16(_rand(cuda, 94, 1, 6, 7, 8))
    with pytest.raises(RuntimeError, match="float32"):
        fused_conv.conv3x3(xb, wt.requires_grad_())
    with pytest.raises(TypeError, match="bfloat16"):
        fused_conv.conv3x3(xb.float(), wt.detach(), res=_bf16(x.detach()))


FAST_SETS = {
    "exact flags": dict(batch_mgaa=True, tail_impl="folded",
                        iac_chain="resident", scnet_fuse="quad"),
    "fast": cli.FAST,
    "fast resident quad": cli.serving_flags(True, "resident", "quad"),
    "tail bf16": dict(tail_dtype="bf16"),
    "tail bf16 folded_pb": dict(tail_dtype="bf16", tail_impl="folded_pb"),
}


@pytest.mark.parametrize("name", list(FAST_SETS))
def test_small_model_serving_flags_gpu_match_cpu(cuda, name):
    """FCVSR-S under each serving flag set on the card against the same
    model on the CPU: 1e-4 for the exact flags (as the flagless model),
    the JAX package's --fast bars for bf16 (max 0.02, mean 2e-3); the
    launches of a forward: 3 MGAA calls (2 with batch_mgaa) x 2 directions
    x 3 iterations (or 4 chains), 2 x 3 x 3 pairs a group (or half as many
    quads), 3 group convs a group, and conv_last0 (on bf16 maps under
    tail_dtype) unless it is folded into the tail."""
    flags = FAST_SETS[name]
    model = init_weights(FCVSRNet.small(in_channels=1, **flags),
                         torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(22).uniform(
        0, 1, (1, 7, 1, 20, 28)).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        model.to(cuda)
        before = launch_counts()
        got = model(x.to(cuda)).cpu()
        after = launch_counts()
    n = {k: after[k] - before[k] for k in after}
    resident = flags.get("iac_chain") == "resident"
    quad = flags.get("scnet_fuse") == "quad"
    calls = 2 if flags.get("batch_mgaa") else 3
    folded = flags.get("tail_impl", "xla") != "xla"
    want = dict.fromkeys(n, 0)
    want.update(iac=0 if resident else calls * 6,
                iac_chain=4 if resident else 0,
                conv3x3_pair=0 if quad else 72, conv3x3_quad=36 if quad else 0,
                conv3x3=12 if folded else 13)
    assert n == want, n
    d = (got - ref).abs()
    if "bf16" in flags.values():
        assert float(d.max()) < 0.02 and float(d.mean()) < 2e-3
    else:
        assert float(d.max()) <= 1e-4


def _block_rcb_case(dev, seed, b, h, w, c, c1):
    """A BlockRCB level's input (bf16) and weights, N(0, 0.2) as the A/B
    draws them."""
    x = _bf16(_rand(dev, seed, b, h, w, c).clamp(-1, 1))
    r = lambda i, *s: _rand(dev, seed + i, *s, scale=0.2)  # noqa: E731
    return x, dict(wb0=r(1, 3, 3, c, c1), bb0=r(2, c1), wb1=r(3, 3, 3, c1, c),
                   bb1=r(4, c), wr0=r(5, 3, 3, c, c), wr1=r(6, 3, 3, c, c),
                   w_mask=r(7, c), w_add0=r(8, c, c), w_add1=r(9, c, c))


@pytest.mark.parametrize("b,h,w,c,c1", [
    (1, 5, 7, 16, 16),     # H and W below one row segment
    (2, 13, 29, 16, 32),   # segments cut at both edges, C1 = 2C, two images
    (1, 37, 50, 64, 128),  # FCVSR's widths
    (2, 9, 17, 24, 24),    # C not a multiple of 16, 256 not a multiple of C
    (2, 20, 33, 64, 64)])  # C1 = C, two images
def test_blockrcb_kernel_matches_plain(cuda, b, h, w, c, c1):
    """K11, one cooperative launch, against its plain version at the bf16
    bar; each image's softmax over its own pixels only."""
    from fcvsr_tpu_torch.ops.fused_blockrcb import block_rcb, block_rcb_plain

    x, kw = _block_rcb_case(cuda, 90, b, h, w, c, c1)
    n0 = block_rcb.launches
    got = block_rcb(x, **kw)
    assert block_rcb.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _assert_close_as(got, block_rcb_plain(x, **kw), 1e-4)
    if b == 2:  # the first image alone gives the same output
        _assert_close_as(block_rcb(x[:1].contiguous(), **kw), got[:1], 1e-4)


@pytest.mark.parametrize("b,h,w,c,c1", [
    (2, 13, 29, 16, 32), (1, 37, 50, 64, 128), (2, 9, 17, 24, 24),
    (1, 70, 130, 64, 64)])  # more work items than one wave of the grid
def test_blockrcb_conv_phases_equal_quad(cuda, b, h, w, c, c1):
    """K11's y and r, read through scratch handed to the wrapper, equal a
    K6 launch on the same input with the weights rounded to bf16
    beforehand (K6's lo weight products are then zero) bit for bit: the
    two run K2's loop over the same items."""
    from fcvsr_tpu_torch.ops.fused_blockrcb import block_rcb

    x, kw = _block_rcb_case(cuda, 91, b, h, w, c, c1)
    scratch = (torch.empty_like(x), torch.empty_like(x))
    with torch.no_grad():
        block_rcb(x, **kw, scratch=scratch)
        rw = {n: kw[n].bfloat16().float() for n in ("wb0", "wb1", "wr0",
                                                     "wr1")}
        y, r = fused_conv.conv3x3_quad(x, rw["wb0"], kw["bb0"], rw["wb1"],
                                       kw["bb1"], rw["wr0"], None, rw["wr1"],
                                       None, 0.1, 0.2)
    torch.cuda.synchronize()
    assert torch.equal(scratch[0], y) and torch.equal(scratch[1], r)


def test_blockrcb_kernel_takes_k2s_channels_on_the_tensor_cores(cuda):
    """K11 refuses C above 64 and C1 above 128, what K2's loop takes, and
    its kernels' SASS holds wgmma (HGMMA), as chip_smoke.py checks."""
    from fcvsr_tpu_torch.ops import _native
    from fcvsr_tpu_torch.ops.fused_blockrcb import block_rcb

    for c, c1 in ((72, 72), (64, 192)):
        x, kw = _block_rcb_case(cuda, 92, 1, 5, 7, c, c1)
        with pytest.raises(ValueError, match="C up to 64"):
            block_rcb(x, **kw)
    sass = _native.sass_ops(_native.lib()._name, "blockrcb_kernel",
                            ("HGMMA",))
    if sass is None:
        pytest.skip("the toolkit has no cuobjdump")
    assert len(sass) == 2 and all(ops["HGMMA"] for ops in sass.values()), \
        sass


def test_probe_kernel_builds_and_runs(cuda):
    """K12: scale2.cu built alone for sm_90a, loaded by ctypes; o = 2 x
    exactly, at the probe's (8, 128) and at a size with a ragged block."""
    from fcvsr_tpu_torch.tools import gpu_probe

    for shape in ((8, 128), (1000,)):
        x = _rand(cuda, 95, *shape)
        n0 = gpu_probe.scale2.launches
        got = gpu_probe.scale2(x)
        torch.cuda.synchronize()
        assert gpu_probe.scale2.launches == n0 + 1
        assert torch.equal(got, 2 * x)
    assert gpu_probe.probe_lib()[0] is not None


def test_kernels_launch_on_their_tensors_device(cuda):
    """K1, K2, K7, K8 and K11 on cuda:1 with cuda:0 current, against their
    plain versions at each kernel's bar: every launch enters its tensors'
    device.  Needs two cards."""
    from fcvsr_tpu_torch.ops.fused_blockrcb import block_rcb, block_rcb_plain

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    feat, fin = _rand(dev, 0, 2, 13, 29, 20), _rand(dev, 1, 2, 13, 29, 20)
    flow = _flows(dev, 2, 2, 13, 29, 1.5)
    k = _rand(dev, 3, 2, 13, 29, 60, scale=0.3)
    x = _rand(dev, 10, 2, 9, 19, 24)
    w1, w2 = _rand(dev, 11, 3, 3, 24, 40, scale=0.1), \
        _rand(dev, 12, 3, 3, 40, 24, scale=0.1)
    dcn = _dcn_case(dev, 60, 2, 13, 29, 24, 40, 3, True)
    xb, kw = _block_rcb_case(dev, 90, 2, 13, 29, 16, 32)
    with torch.cuda.device(0):
        iac = fused_iac.warp_sac_fused(feat, flow, k, fin)
        pair = fused_conv.conv3x3_pair(x, w1, None, w2, None)
        out = fused_dcn.modulated_deform_conv2d_fused(*dcn[:5],
                                                      deform_groups=3)
        grads = fused_dcn.modulated_deform_conv2d_fused_vjp(*dcn,
                                                            deform_groups=3)
        level = block_rcb(xb, **kw)
        assert torch.cuda.current_device() == 0
    for t in (iac, pair, out, level, *grads):
        assert t.device == dev
    torch.cuda.synchronize(dev)
    _assert_close(iac, fused_iac.warp_sac_plain(feat, flow, k, fin), 2e-5)
    _assert_close(pair, fused_conv.conv3x3_pair_plain(x, w1, None, w2, None),
                  1e-4)
    _assert_close(out, modulated_deform_conv2d(*dcn[:5], deform_groups=3),
                  1e-4)
    _assert_grads_close(grads, modulated_deform_conv2d_vjp(*dcn, 3), 1e-4)
    _assert_close_as(level, block_rcb_plain(xb, **kw), 1e-4)


def test_kernels_launch_on_the_current_stream(cuda):
    """K2, K11 and the two persistent cooperative launches, K4 and K6,
    launched from a side stream: their results are complete once that
    stream alone is synchronised."""
    from fcvsr_tpu_torch.ops.fused_blockrcb import block_rcb, block_rcb_plain

    x = _rand(cuda, 10, 2, 37, 50, 64)
    w1, w2 = _rand(cuda, 11, 3, 3, 64, 128, scale=0.05), \
        _rand(cuda, 12, 3, 3, 128, 64, scale=0.05)
    r1, r2 = _rand(cuda, 13, 3, 3, 64, 64, scale=0.05), \
        _rand(cuda, 14, 3, 3, 64, 64, scale=0.05)
    quad = (w1, None, w2, None, r1, None, r2, None)
    xb, kw = _block_rcb_case(cuda, 90, 2, 37, 50, 64, 128)
    fin = _rand(cuda, 15, 2, 37, 50, 64)
    k = _rand(cuda, 16, 2, 37, 50, 3 * 3 * 64, scale=0.3)
    offs = torch.stack([_flows(cuda, 17 + i, 2, 37, 50, 1.5)
                        for i in range(3)])
    ref_pair = fused_conv.conv3x3_pair_plain(x, w1, None, w2, None)
    ref_quad = fused_conv.conv3x3_quad_plain(x, *quad)
    ref_level = block_rcb_plain(xb, **kw)
    ref_chain = fused_iac.iac_chain_plain(fin, k, offs, 3)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        pair = fused_conv.conv3x3_pair(x, w1, None, w2, None)
        y, out = fused_conv.conv3x3_quad(x, *quad)
        level = block_rcb(xb, **kw)
        chain = fused_iac.iac_fused_resident(fin, k, offs, 3)
    s.synchronize()
    _assert_close(pair, ref_pair, 1e-4)
    _assert_close(y, ref_quad[0], 1e-4)
    _assert_close(out, ref_quad[1], 1e-4)
    _assert_close_as(level, ref_level, 1e-4)
    _assert_close(chain, ref_chain, CHAIN_RTOL)


# K9 and K10, the probes' kernels (csrc/microbench/), against their plain
# versions: at the probes' real shape, at 3 tiles of 200 lanes, where the
# mm kernel's last 128-lane chunk and the window kernel's last 64-lane
# unit are cut, and at 2 tiles of 3 rows and 136 lanes, where the mm
# kernel's last chunk holds 8 lanes (its second TMA box lies wholly past
# WP) and a tile is short of rows: a wrong wgmma descriptor offset or
# accumulator layout shows there.  The mm and window probes sum up to 576
# float32 values in another order: 1e-4 of max|plain|; the copies are
# exact.
MB_SHAPES = [dict(th=16, c=64, wp=512, tiles=17),
             dict(th=16, c=64, wp=200, tiles=3),
             dict(th=3, c=64, wp=136, tiles=2)]
MB_IDS = ["real", "odd", "short"]
# the window kernel's units (a source row x 64 lanes, fewer for wider C):
# one tile of 5 rows, 100 lanes (a last unit of 36) and C 24, where the
# lane wrap of im2col's box and the last unit show; C 96 and 160 (32- and
# 16-lane units), a row in three windows (TH 1) and in two (TH 2)
WIN_SHAPES = MB_SHAPES + [dict(th=5, c=24, wp=100, tiles=1),
                          dict(th=1, c=96, wp=40, tiles=4),
                          dict(th=2, c=160, wp=20, tiles=3)]
WIN_IDS = MB_IDS + ["wrap", "c96", "c160"]
# the copies' plans: 17 tiles of 400 lanes, where a one-shot share of 206
# to 208 KB in float32 is 2 copies of 103 or 104 KB, not a whole number of
# equal copies (102 to 104 KB in bf16: 2 of 51 or 52); at the real shape
# the float32 share is 3 copies of 88 or 89 KB through the 2 buffers, the
# third issued as the first is folded
COPY_SHAPES = MB_SHAPES + [dict(th=16, c=64, wp=400, tiles=17)]
COPY_IDS = MB_IDS + ["ring"]


@pytest.mark.parametrize("shape", MB_SHAPES, ids=MB_IDS)
@pytest.mark.parametrize("probe", ["mm_stream", "mm_stream3"])
def test_mm_probe_kernel_matches_plain(cuda, probe, shape):
    """Twice: each call's checksums come out the same, bit for bit."""
    from fcvsr_tpu_torch.benchmarks import microbench_conv2 as conv2

    rhs, w, _ = (t.to(cuda) for t in conv2.seeded_operands(1, **shape))
    fn = getattr(conv2, probe)
    n0 = fn.launches
    out, sums = fn(rhs, w, shape["tiles"])
    out2, sums2 = fn(rhs, w, shape["tiles"])
    assert fn.launches == n0 + 2
    ref, ref_sums = getattr(conv2, probe + "_plain")(rhs, w, shape["tiles"])
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (shape["th"], 64, shape["wp"])
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.isfinite(sums).all() and torch.equal(sums, sums[:1].expand(
        shape["tiles"]))
    assert torch.equal(sums, sums2) and torch.equal(out, out2)
    tol = 1e-4 * float(ref.double().abs().sum())
    assert float((sums.double() - ref_sums.double()).abs().max()) <= tol


@pytest.mark.parametrize("shape", WIN_SHAPES, ids=WIN_IDS)
@pytest.mark.parametrize("probe", ["im2col", "dma_window"])
def test_window_probe_kernel_matches_plain(cuda, probe, shape):
    from fcvsr_tpu_torch.benchmarks import microbench_conv2 as conv2

    _, _, src = conv2.seeded_operands(2, **shape)
    src = src.to(cuda)
    fn = getattr(conv2, probe)
    n0 = fn.launches
    got = fn(src, shape["th"])
    assert fn.launches == n0 + 1
    ref = getattr(conv2, probe + "_plain")(src, shape["th"])
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("shape", COPY_SHAPES, ids=COPY_IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("probe", ["dma_one_shot", "dma_serial", "dma_dbuf"])
def test_copy_probe_kernel_matches_plain(cuda, probe, dtype, shape):
    from fcvsr_tpu_torch.benchmarks import microbench_dma as dma

    src32, src16 = dma.seeded_source(3, **shape)
    src = (src32 if dtype == torch.float32 else src16).to(cuda)
    fn = getattr(dma, probe)
    args = (src,) if probe == "dma_one_shot" else (src, shape["th"])
    n0 = fn.launches
    got, folds = fn(*args)
    assert fn.launches == n0 + 1
    ref, ref_folds = getattr(dma, probe + "_plain")(*args)
    torch.cuda.synchronize()
    assert got.shape == (1, 1, shape["wp"]) and torch.equal(got, ref)
    assert folds.shape == ref_folds.shape and torch.equal(folds, ref_folds)


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """C other than 64 and WP not a multiple of 8 (TMA's 16-byte row
    stride) for the mm kernel, WP not a multiple of 4 (the same stride in
    float32) and C over 256 (a TMA box's rows) for the window kernel (the
    wrappers, launching nothing), and rows that are not a multiple of 16
    bytes for the bulk copies (the launch refuses them)."""
    from fcvsr_tpu_torch.benchmarks import microbench_conv2 as conv2
    from fcvsr_tpu_torch.benchmarks import microbench_dma as dma

    rhs, w, _ = (t.to(cuda) for t in conv2.seeded_operands(
        0, th=4, c=8, wp=128, tiles=3))
    with pytest.raises(ValueError, match="C = 64"):
        conv2.mm_stream(rhs, w, 3)
    rhs, w, _ = (t.to(cuda) for t in conv2.seeded_operands(
        0, th=2, c=64, wp=130, tiles=1))
    n0 = conv2.mm_stream3.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        conv2.mm_stream3(rhs, w, 1)
    assert conv2.mm_stream3.launches == n0
    n0 = conv2.im2col.launches, conv2.dma_window.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        conv2.im2col(torch.zeros(1, 18, 8, 6, device=cuda), 16)
    with pytest.raises(ValueError, match="C <= 256"):
        conv2.dma_window(torch.zeros(1, 18, 300, 16, device=cuda), 16)
    assert (conv2.im2col.launches, conv2.dma_window.launches) == n0
    with pytest.raises(RuntimeError, match="invalid argument"):
        dma.dma_serial(torch.zeros(1, 18, 3, 5, device=cuda), 16)


# the batches the serving modes put through the kernels: ETC's 7 windows
# and tiled serving's 15 tiles of a 540x960 frame (K1 and K4 take twice as
# many under batch_mgaa)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [7, 15])
def test_kernels_at_serving_batches(cuda, b, dtype):
    """K1 (both modes), K2, K3, K4 and K6 at batch 7 and 15 against their
    plain versions, at a small odd shape (tiles cut at both edges, an
    8-channel block cut short)."""
    h, w, c, ac = 11, 23, 20, 2
    x = _rand(cuda, 140, b, h, w, c).to(dtype)
    fin = _rand(cuda, 141, b, h, w, c).to(dtype)
    k = _rand(cuda, 142, b, h, w, ac * 3 * c, scale=0.3).to(dtype)
    offs = torch.stack([_flows(cuda, 143 + i, b, h, w, 1.5)
                        for i in range(ac)])
    f0 = _rand(cuda, 146, b, h, w, 24).to(dtype)
    wsel = _rand(cuda, 147, 24, ac * 3 * c, scale=0.2)
    bsel = _rand(cuda, 148, ac * 3 * c, scale=0.1)
    _assert_close_as(fused_iac.warp_sac_fused(x, offs[1], k, fin, True, 1),
                     fused_iac.warp_sac_plain(x, offs[1], k, fin, True, 1),
                     2e-5)
    _assert_close_as(
        fused_iac.warp_sac_fused_kf(x, offs[0], f0, wsel, bsel, fin, False, 1),
        fused_iac.warp_sac_plain(x, offs[0], fused_iac.predict_kernels(
            f0, wsel, bsel, 1, c), fin, False), 2e-5)
    _assert_close_as(fused_iac.iac_fused_resident(fin, k, offs, ac),
                     fused_iac.iac_chain_plain(fin, k, offs, ac), CHAIN_RTOL)
    chans = (c, 40, c, c, c)
    ws = [_rand(cuda, 150 + i, 3, 3, ci, co, scale=0.1)
          for i, (ci, co) in enumerate(zip(chans, chans[1:]))]
    bs = [_rand(cuda, 155 + i, co, scale=0.1) for i, co in
          enumerate(chans[1:])]
    args = [t for pair in zip(ws, bs) for t in pair]
    _assert_close_as(fused_conv.conv3x3_pair(x, *args[:4], 0.1),
                     fused_conv.conv3x3_pair_plain(x, *args[:4], 0.1), 1e-4)
    for got, ref in zip(fused_conv.conv3x3_quad(x, *args),
                        fused_conv.conv3x3_quad_plain(x, *args)):
        _assert_close_as(got, ref, 1e-4)
    _assert_close_as(fused_conv.conv3x3(x, ws[2], bs[2], res=fin),
                     fused_conv.conv3x3_plain(x, ws[2], bs[2], res=fin), 1e-4)


@pytest.mark.parametrize("cout", [1, 3])
def test_conv_last0_narrow_kernel_on_bf16_maps(cuda, cout):
    """K3's narrow variant (Cout <= 8) as conv_last0 runs it under
    tail_dtype='bf16': 64 bf16 channels in, Y or RGB out in bf16, at an
    upsampled shape (4 x an odd LR size)."""
    x = _bf16(_rand(cuda, 160, 1, 4 * 9, 4 * 13, 64))
    wt = _rand(cuda, 161, 3, 3, 64, cout, scale=0.05)
    bias = _rand(cuda, 162, cout, scale=0.1)
    n0 = fused_conv.conv3x3.launches
    got = fused_conv.conv3x3(x, wt, bias)
    assert fused_conv.conv3x3.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (1, 36, 52, cout)
    _assert_close_as(got, fused_conv.conv3x3_plain(x, wt, bias), 1e-4)


def test_serving_modes_gpu_match_cpu(cuda):
    """fcvsr_etc_forward (13 frames, the 7 windows as one batch) and
    tiled_sr (4 tiles of 32, overlap 8) of FCVSR-S on the card against the
    same calls on the CPU, at 1e-3, as chip_smoke.py holds the model."""
    model = init_weights(FCVSRNet.small(in_channels=1),
                         torch.Generator().manual_seed(6)).eval()
    rng = np.random.default_rng(23)
    clip = torch.from_numpy(rng.uniform(0, 1, (1, 13, 1, 12, 20))
                            .astype(np.float32))
    win = rng.uniform(0, 1, (7, 1, 48, 44)).astype(np.float32)
    with torch.no_grad():
        ref = fcvsr_etc_forward(model, clip)
        ref_tiles = tiled_sr(model, win, tile=32, overlap=8, device="cpu")
        model.to(cuda)
        got = fcvsr_etc_forward(model, clip.to(cuda))
        got_tiles = tiled_sr(model, win, tile=32, overlap=8)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (1, 7, 1, 48, 80)
        assert float((g.cpu() - r).abs().max()) <= 1e-3
    assert got_tiles.shape == ref_tiles.shape == (1, 1, 192, 176)
    assert float(np.abs(got_tiles - ref_tiles).max()) <= 1e-3


# TDAN's DCNv1 (mmcv's DeformConv2dPack): no mask, no bias, 8 deform
# groups, 64 -> 64; at its training batch (4 neighbours of 4 windows at 64
# x 64, one batch) and at small odd frames that cut K7's 128-pixel and
# K8's 64-pixel tiles at the frame's edge, with group widths of 8, 3
# (scalar corners) and 2
@pytest.mark.parametrize("b,h,w,cin,cout", [
    (16, 64, 64, 64, 64), (2, 13, 29, 64, 64), (1, 5, 7, 24, 40),
    (3, 9, 11, 16, 8)])
def test_dcnv1_kernels_match_plain(cuda, b, h, w, cin, cout):
    x, off, _, wt, _, g = _dcn_case(cuda, 170, b, h, w, cin, cout, 8,
                                    with_mask=False, bias=False)
    n0 = (fused_dcn.modulated_deform_conv2d_fused.launches,
          fused_dcn.modulated_deform_conv2d_fused_vjp.launches)
    got = fused_dcn.modulated_deform_conv2d_fused(x, off, None, wt, None,
                                                  deform_groups=8)
    _assert_close(got, modulated_deform_conv2d(x, off, None, wt, None,
                                               deform_groups=8), 1e-4)
    grads = fused_dcn.modulated_deform_conv2d_fused_vjp(x, off, None, wt, None,
                                                        g, deform_groups=8)
    assert grads[2] is None and grads[4] is None
    _assert_grads_close(grads, modulated_deform_conv2d_vjp(
        x, off, None, wt, None, g, 8), 1e-4)
    assert (fused_dcn.modulated_deform_conv2d_fused.launches,
            fused_dcn.modulated_deform_conv2d_fused_vjp.launches) == \
        (n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_bf16_weights_cast_up(cuda, dtype):
    """K1 (its fused prediction's Wsel and bias), K2 and K3 handed bf16
    weights, as a model cast whole to bf16 hands them: the wrappers cast
    them up to float32, so each launch equals the same launch on float32
    copies of those weights, bit for bit, on float32 and bf16 maps."""
    h, w, c, c0 = 11, 23, 16, 12
    x = _rand(cuda, 180, 1, h, w, c).to(dtype)
    flow = _flows(cuda, 181, 1, h, w, 1.5)
    f0 = _rand(cuda, 182, 1, h, w, c0).to(dtype)
    ws = [_rand(cuda, 183 + i, *s, scale=0.1).bfloat16() for i, s in
          enumerate(((c0, 3 * c), (3 * c,), (3, 3, c, 24), (24,),
                     (3, 3, 24, c), (c,)))]
    up = [t.float() for t in ws]
    got = fused_iac.warp_sac_fused_kf(x, flow, f0, ws[0], ws[1], x)
    want = fused_iac.warp_sac_fused_kf(x, flow, f0, up[0], up[1], x)
    assert torch.equal(got, want)
    assert torch.equal(fused_conv.conv3x3_pair(x, *ws[2:6], 0.1),
                       fused_conv.conv3x3_pair(x, *up[2:6], 0.1))
    assert torch.equal(fused_conv.conv3x3(x, ws[2], ws[3], act=True),
                       fused_conv.conv3x3(x, up[2], up[3], act=True))


def test_small_model_bf16_gpu_matches_cpu(cuda):
    """FCVSR-S wholly in bf16 (``utils.precision.bf16_apply``) on the card
    against the same on the CPU, at the --fast bars: K1, K2 and K3 launched
    on bf16 maps."""
    from fcvsr_tpu_torch.utils.precision import bf16_apply, cast_params

    model = cast_params(init_weights(FCVSRNet.small(in_channels=1),
                                     torch.Generator().manual_seed(12))
                        .eval())
    x = torch.from_numpy(np.random.default_rng(24).uniform(
        0, 1, (2, 7, 1, 20, 28)).astype(np.float32))
    with torch.no_grad():
        ref = bf16_apply(model, x)
        before = launch_counts()
        got = bf16_apply(model.to(cuda), x.to(cuda)).cpu()
        after = launch_counts()
    assert all(after[k] > before[k] for k in ("iac", "conv3x3_pair",
                                               "conv3x3")), (before, after)
    d = (got - ref).abs()
    assert got.dtype == torch.float32 and got.shape == (2, 1, 80, 112)
    assert float(d.max()) < 0.02 and float(d.mean()) < 2e-3


# the new zoo models, small, their DCNs' offset convs drawn non-zero: the
# card against the CPU at 1e-3, with the DCN launches a forward (BasicVSR
# none; IconVSR 4 a keyframe, its refill's PCD; TDAN 4, the neighbours one
# batch) and, for the two with DCNs, one step's gradients as
# test_zoo_model_gpu_grads_match_cpu holds EDVR's and BasicVSR++'s; FTVSR
# and TTVSR (no kernel) over 5 frames, keyframes every 2, so that LTAM
# chooses between 2 keyframes at 4 steps of each direction
MORE_ZOO = {
    "BasicVSRNet": (dict(mid_channels=16, num_blocks=1), (1, 4, 3, 64, 64),
                    0),
    "IconVSR": (dict(mid_channels=16, num_blocks=1, keyframe_stride=3),
                (1, 6, 3, 64, 64), 4 * 3),
    "TDANNet": (dict(mid_channels=16, num_blocks_before_align=1,
                     num_blocks_after_align=1), (2, 5, 3, 20, 28), 4),
    "FTVSRNet": (dict(mid_channels=16, num_blocks=1, d_model=16, n_heads=4,
                      keyframe_stride=2), (1, 5, 3, 64, 64), 0),
    "TTVSRNet": (dict(mid_channels=16, num_blocks=1, keyframe_stride=2),
                 (1, 5, 3, 64, 64), 0),
}
# gradients that are 0 in exact arithmetic (a softmax ignores one vector
# added to every key): rounding on both devices, held to 1e-6 of the whole
# gradient's norm instead of the per-tensor bar
ZERO_GRADS = ("ftta.layer_k.bias",)


def _more_zoo(name):
    kw, shape, dcns = MORE_ZOO[name]
    model = init_weights(build(BACKBONES, dict(type=name, **kw)),
                         torch.Generator().manual_seed(13))
    gen = torch.Generator().manual_seed(14)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ModulatedDeformConv2d):
                last = [m for m in mod.conv_offset.modules()
                        if isinstance(m, torch.nn.Conv2d)][-1]
                last.weight.normal_(0, 0.02, generator=gen)
                last.bias.normal_(0, 3.0, generator=gen)
    x = torch.from_numpy(np.random.default_rng(15).uniform(0, 1, shape)
                         .astype(np.float32))
    return model, x, dcns


def _sr(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", list(MORE_ZOO))
def test_more_zoo_models_gpu_match_cpu(cuda, name):
    model, x, dcns = _more_zoo(name)
    model.eval()
    with torch.no_grad():
        ref = model(x)
        before = launch_counts()
        got = model.to(cuda)(x.to(cuda))
        after = launch_counts()
    assert after["dcn"] - before["dcn"] == dcns
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert g.shape == r.shape
        assert float((g.cpu() - r).abs().max()) <= 1e-3


@pytest.mark.parametrize("name", ["IconVSR", "TDANNet", "FTVSRNet"])
def test_more_zoo_models_gpu_grads_match_cpu(cuda, name):
    model, x, dcns = _more_zoo(name)
    gt = torch.from_numpy(np.random.default_rng(16).uniform(
        0, 1, _sr(model(x)).shape).astype(np.float32))
    model.zero_grad(set_to_none=True)
    charbonnier_sum(_sr(model(x)), gt).backward()
    ref = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.to(cuda)
    before = launch_counts()
    charbonnier_sum(_sr(model(x.to(cuda))), gt.to(cuda)).backward()
    after = launch_counts()
    assert after["dcn"] - before["dcn"] == dcns
    assert after["dcn_bwd"] - before["dcn_bwd"] == dcns
    got = {k: p.grad.cpu() for k, p in model.named_parameters()}
    norm = float(torch.cat([r.flatten() for r in ref.values()]).norm())
    for k in ZERO_GRADS:
        if k in ref:
            assert max(float(ref[k].norm()), float(got[k].norm())) <= \
                1e-6 * norm
    rel = {k: float((got[k] - r).norm() / r.norm()) for k, r in ref.items()
           if r.any() and k not in ZERO_GRADS}
    whole = float(torch.cat([(got[k] - r).flatten() for k, r in
                             ref.items()]).norm()) / norm
    assert whole <= 1e-3 and float(np.median(list(rel.values()))) <= 1e-3
    assert max(rel.values()) <= 5e-2, max(rel.items(), key=lambda kv: kv[1])
