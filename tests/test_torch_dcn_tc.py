"""The deformable conv (K7, csrc/dcn.cu) and its adjoint (K8,
csrc/dcn_bwd.cu) on the tensor cores, emulated on the CPU.

``fused_dcn.modulated_deform_conv2d_emulated`` and
``modulated_deform_conv2d_vjp_emulated`` round the factors of each
contraction (cols x W, g x W^T, cols^T x g) to bf16 on their bits, split
them into hi and lo parts and sum the route's products in float32, as the
kernels' wgmma do; dx, doffset and dmask follow from the route's u in
float32, as in K8.  On the very inputs of the GPU tests
(tests/test_torch_kernels_gpu.py::test_dcn_kernel_matches_plain and
::test_dcn_bwd_kernel_matches_plain, drawn from the same numpy seeds) and
at the zoo's two layouts (EDVR-M 64 -> 64 with 8 deform groups,
BasicVSR++ 128 -> 64 with 16) at a small frame, the kernels' route,
bf16x3, holds the bars they are held to on the card: the forward 1e-4 of
max(1, max|plain|), each gradient 1e-4 of its own max; one bf16 product
misses them at the zoo's layouts.

Also on the CPU: which layouts the adjoint writes doffset and dmask whole
for (``fused_dcn.offsets_written_whole``), and that the takeouts of the A/B
(``benchmarks/dcn_ab.py``) still apply to the kernels' sources.
"""

import numpy as np
import pytest
import torch

from fcvsr_tpu_torch.benchmarks import dcn_ab
from fcvsr_tpu_torch.ops import _native, fused_dcn
from fcvsr_tpu_torch.ops.dcn import (modulated_deform_conv2d,
                                     modulated_deform_conv2d_vjp)

RTOL = 1e-4


def _rand(seed, *shape, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32))


def _flows(seed, b, h, w, scale):
    """The GPU tests' offsets of one tap: small, +-20 px in the top third,
    out of frame at the bottom and the left edge."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, h, w, 2)) * scale
    f[:, : max(1, h // 3)] = rng.uniform(-20, 20, (b, max(1, h // 3), w, 2))
    f[:, -max(1, h // 6):, :, 0] += 3 * w
    f[:, :, : max(1, w // 8), 1] -= 3 * h
    return torch.from_numpy(f.astype(np.float32))


def _offsets(seed, b, h, w, dg):
    return torch.cat([_flows(seed + i, b, h, w, 1.5) for i in range(9 * dg)],
                     -1)


def _fwd_case(b, h, w, cin, cout, dg, with_mask):
    """test_dcn_kernel_matches_plain's inputs."""
    x = _rand(50, b, h, w, cin)
    off = _offsets(51, b, h, w, dg)
    mask = torch.sigmoid(_rand(52, b, h, w, 9 * dg)) if with_mask else None
    return x, off, mask, _rand(53, 3, 3, cin, cout, scale=0.1), \
        _rand(54, cout)


def _bwd_case(b, h, w, cin, cout, dg, with_mask, bias, seed=60):
    """test_dcn_bwd_kernel_matches_plain's inputs (``_dcn_case``)."""
    x = _rand(seed, b, h, w, cin)
    off = _offsets(seed + 1, b, h, w, dg)
    mask = torch.sigmoid(_rand(seed + 2, b, h, w, 9 * dg)) \
        if with_mask else None
    wt = _rand(seed + 3, 3, 3, cin, cout, scale=1 / np.sqrt(9 * cin))
    bb = _rand(seed + 4, cout) if bias else None
    return x, off, mask, wt, bb, _rand(seed + 5, b, h, w, cout)


FWD_CASES = [  # test_dcn_kernel_matches_plain's
    (2, 13, 29, 24, 40, 3, True), (1, 5, 7, 8, 70, 1, True),
    (2, 9, 21, 64, 64, 8, False), (1, 12, 10, 128, 64, 16, True),
    (1, 6, 11, 64, 20, 1, True), (2, 9, 11, 6, 20, 2, True),
    (1, 7, 6, 32, 12, 8, True), (2, 10, 13, 96, 72, 4, False)]
BWD_CASES = [  # test_dcn_bwd_kernel_matches_plain's
    (2, 13, 29, 24, 40, 3, True, True), (1, 5, 7, 8, 70, 1, True, False),
    (2, 9, 21, 64, 64, 8, False, True), (1, 12, 10, 128, 64, 16, True, True),
    (1, 6, 11, 64, 20, 1, True, True), (3, 17, 19, 48, 24, 2, True, True),
    (2, 9, 11, 6, 20, 2, True, True), (1, 7, 6, 32, 12, 8, True, False),
    (2, 10, 13, 96, 100, 4, False, True)]
ZOO = {"edvr_m": (1, 8, 10, 64, 64, 8), "basicvsr_pp": (1, 8, 10, 128, 64, 16)}


def _fwd_err(got, ref):
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _bwd_err(got, ref):
    """The largest of each gradient's max deviation over its own max."""
    errs = []
    for a, r in zip(got, ref):
        assert (a is None) == (r is None)
        if r is not None:
            errs.append(float((a - r).abs().max()) / float(r.abs().max()))
    return max(errs)


@pytest.mark.parametrize("case", FWD_CASES + [(*z, True) for z in ZOO.values()])
def test_forward_route_holds_the_bar(case):
    b, h, w, cin, cout, dg, with_mask = case
    x, off, mask, wt, bias = _fwd_case(*case)
    ref = modulated_deform_conv2d(x, off, mask, wt, bias, deform_groups=dg)
    got = fused_dcn.modulated_deform_conv2d_emulated(x, off, mask, wt, bias,
                                                     dg)
    assert got.shape == ref.shape
    assert _fwd_err(got, ref) <= RTOL


@pytest.mark.parametrize(
    "case", BWD_CASES + [(*z, True, True) for z in ZOO.values()])
def test_adjoint_route_holds_the_bar(case):
    b, h, w, cin, cout, dg, with_mask, bias = case
    ins = _bwd_case(*case)
    ref = modulated_deform_conv2d_vjp(*ins, dg)
    got = fused_dcn.modulated_deform_conv2d_vjp_emulated(*ins, dg)
    assert _bwd_err(got, ref) <= RTOL


@pytest.mark.parametrize("zoo", sorted(ZOO))
def test_one_bf16_product_misses_the_bars(zoo):
    """The route is not free: one bf16 product a k step (the TPU kernels'
    precision) misses both bars at the zoo's layouts."""
    b, h, w, cin, cout, dg = ZOO[zoo]
    x, off, mask, wt, bias = _fwd_case(b, h, w, cin, cout, dg, True)
    ref = modulated_deform_conv2d(x, off, mask, wt, bias, deform_groups=dg)
    got = fused_dcn.modulated_deform_conv2d_emulated(x, off, mask, wt, bias,
                                                     dg, route="bf16")
    assert _fwd_err(got, ref) > RTOL
    ins = _bwd_case(b, h, w, cin, cout, dg, True, True)
    ref = modulated_deform_conv2d_vjp(*ins, dg)
    got = fused_dcn.modulated_deform_conv2d_vjp_emulated(*ins, dg,
                                                         route="bf16")
    assert _bwd_err(got, ref) > RTOL


@pytest.mark.parametrize("cin,dg,whole", [
    (64, 8, True), (128, 16, True), (64, 1, True), (24, 3, True),
    (32, 8, True), (48, 2, True), (6, 2, False), (96, 4, False),
    (128, 1, False), (16, 8, False)])
def test_offsets_written_whole(cin, dg, whole):
    """doffset and dmask are stored by the group's first lane where a group
    is float4 runs inside one 64-channel chunk (the zoo's 8-channel groups,
    24-channel groups in one chunk), and summed by atomics into zeroed
    buffers where a group crosses a chunk (96 / 4, 128 / 1) or its corners
    are read as scalars (width 3 or 2); a view off a 16-byte boundary
    reads scalars too."""
    x = torch.zeros(1, 2, 3, cin)
    assert fused_dcn.offsets_written_whole(x, dg) is whole
    if whole:
        shifted = torch.zeros(2 * 3 * cin + 1)[1:].view(1, 2, 3, cin)
        assert not fused_dcn.offsets_written_whole(shifted, dg)


@pytest.mark.parametrize("source,takeouts", [
    (dcn_ab.SOURCE, dcn_ab.TAKEOUTS), (dcn_ab.BWD_SOURCE, dcn_ab.BWD_TAKEOUTS)])
def test_ab_takeouts_apply(source, takeouts):
    """Each takeout of the DCN A/B (``dcn_ab --takeouts``) matches its
    kernel's source: every old text is there, and its variant is the
    source with it replaced."""
    base = _native.edited_sources(source, [])
    for name, edits in takeouts.items():
        want = dict(base)
        for edit in edits:
            fname, old, new = edit if len(edit) == 3 else (source, *edit)
            assert old in want[fname], name
            want[fname] = want[fname].replace(old, new)
        assert _native.edited_sources(source, edits) == want != base, name
