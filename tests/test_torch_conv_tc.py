"""The conv pair's tensor-core product (K2, csrc/conv3x3.cu), emulated on
the CPU: ``fused_conv.conv3x3_pair_emulated`` rounds the maps and the
weights to TF32 or bf16 on their bits, splits them into high and low
parts, and sums the route's products in float32, as the kernel's wgmma
do.  At a small SCNet-like pair (64->128->64, weights at 0.03-0.04, 16x24
px, seeded with numpy) each route is held to the float64 pair:

  - float32 maps: bf16x3 (the kernel's route) and 3xTF32 within CONV_RTOL
    = 1e-4 of max(1, max|out|), the bar chip_smoke.py and the GPU tests
    hold the kernel to; one TF32 pass, and one bf16 pass, miss it (the
    reason for the split);
  - bf16 maps: two passes (x * w_hi + x * w_lo, the kernel's) and one
    within BF16_RTOL = 1.6e-2 of max|out| of the float64 pair on the same
    bf16 rounding of the intermediate; the JAX pair kernel in interpret
    mode (bf16 storage, weights rounded to bf16 as the TPU kernel does)
    within the same bar.

The emulation is also held to the plain version (float32) and to the JAX
package's conv3x3_pair_rows in interpret mode.

The single conv (K3, the same kernel file's one-conv case of K2's main
loop) takes the same routes: ``fused_conv.conv3x3_emulated`` at 64 -> 64
with its residual and leaky relu, and at conv_last0's 64 -> 3 and 64 -> 1,
is held to the float64 conv at CONV_RTOL (float32 maps, bf16x3) and
BF16_RTOL (bf16 maps, two passes).  The IAC kernel's A/B script
(benchmarks/iac_ab.py) is held to its source: its edits apply and each
variant's tree is written and built by a fake nvcc.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcvsr_tpu.ops.pallas_conv import (conv3x3_pair_rows, pad_to_rows,
                                       prep_weight, rows_to_nhwc)
from fcvsr_tpu_torch.ops import fused_conv

CONV_RTOL = 1e-4
BF16_RTOL = 1.6e-2


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    return dict(x=rng.standard_normal((1, 16, 24, 64)),
                w1=rng.standard_normal((3, 3, 64, 128)) * 0.04,
                b1=rng.standard_normal(128) * 0.1,
                w2=rng.standard_normal((3, 3, 128, 64)) * 0.03,
                b2=rng.standard_normal(64) * 0.1)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _f64_pair(p, mid_dtype=None):
    """The pair in float64; with ``mid_dtype`` the input and the
    intermediate rounded to it, as bf16 storage rounds them."""
    x = _t(p["x"], torch.float64)
    if mid_dtype is not None:
        x = x.to(mid_dtype).double()
    mid = torch.nn.functional.leaky_relu(fused_conv._conv_plain(
        x, _t(p["w1"], torch.float64), _t(p["b1"], torch.float64)), 0.1)
    if mid_dtype is not None:
        mid = mid.to(mid_dtype).double()
    return fused_conv._conv_plain(mid, _t(p["w2"], torch.float64),
                                  _t(p["b2"], torch.float64))


def _emulated(p, route, dtype=torch.float32):
    torch.set_num_threads(1)
    return fused_conv.conv3x3_pair_emulated(
        _t(p["x"]).to(dtype), _t(p["w1"]), _t(p["b1"]), _t(p["w2"]),
        _t(p["b2"]), 0.1, route)


@pytest.mark.parametrize("route,holds", [
    ("bf16x3", True), ("3xtf32", True), ("tf32", False), ("bf16", False)])
def test_float32_routes_against_float64(pair, route, holds):
    ref = _f64_pair(pair)
    tol = CONV_RTOL * max(1.0, float(ref.abs().max()))
    err = float((_emulated(pair, route).double() - ref).abs().max())
    assert (err <= tol) == holds, (route, err, tol)
    if route == "bf16x3":  # the kernel's route, by a margin
        assert err <= tol / 5, (err, tol)


@pytest.mark.parametrize("route", ["bf16_w2", "bf16"])
def test_bf16_routes_against_float64(pair, route):
    ref = _f64_pair(pair, torch.bfloat16)
    got = _emulated(pair, route, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = float((got.double() - ref).abs().max())
    assert err <= BF16_RTOL * float(ref.abs().max()), (route, err)


def test_splits_reconstruct_their_values():
    """hi of a bf16 split (8 significant bits) is within 2^-8 of the value
    (relative), hi + lo within 2^-16; of a TF32 split (11 bits) within
    2^-11 and 2^-22.  A product of two split values, less its lo * lo
    term, is then within 3 * 2^-16 of the exact product."""
    v = _t(np.random.default_rng(1).standard_normal(4096) * 10.0)
    for drop, whole, alone in ((16, 2.0 ** -16, 2.0 ** -8),
                               (13, 2.0 ** -22, 2.0 ** -11)):
        hi, lo = fused_conv._split(v, drop)
        assert float(((hi - v).abs() / v.abs()).max()) <= alone
        assert float(((hi + lo - v).abs() / v.abs()).max()) <= whole
        assert torch.equal(fused_conv._round_bits(hi, drop), hi)


def test_emulated_routes_match_plain_and_jax(pair):
    """bf16x3 against the float32 plain version at the float32 bar; the
    one-pass bf16 route against the JAX pair kernel (interpret mode,
    float32 maps), which multiplies in one bf16 pass with float32 sums
    (pallas_conv.py's note): the same roundings, sums in another order, so
    an intermediate within that noise of a bf16 rounding boundary may round
    the other way (2^-8 of it, carried by conv2)."""
    got = _emulated(pair, "bf16x3")
    plain = fused_conv.conv3x3_pair_plain(
        _t(pair["x"]), _t(pair["w1"]), _t(pair["b1"]), _t(pair["w2"]),
        _t(pair["b2"]), 0.1)
    tol = CONV_RTOL * max(1.0, float(plain.abs().max()))
    assert float((got - plain).abs().max()) <= tol
    h, w = pair["x"].shape[1:3]
    ref = rows_to_nhwc(conv3x3_pair_rows(
        pad_to_rows(jnp.asarray(pair["x"], jnp.float32), 8),
        prep_weight(jnp.asarray(pair["w1"], jnp.float32)),
        jnp.asarray(pair["b1"], jnp.float32),
        prep_weight(jnp.asarray(pair["w2"], jnp.float32)),
        jnp.asarray(pair["b2"], jnp.float32), h=h, w=w, ns1=0.1,
        tile_rows=8, interpret=True), h, w)
    ref = torch.from_numpy(np.array(ref, np.float32))
    one = _emulated(pair, "bf16")
    err = float((one - ref).abs().max())
    assert err <= 1e-3 * max(1.0, float(ref.abs().max())), err


def test_sass_ops_counts_every_instantiation(tmp_path, monkeypatch):
    """The SASS check of K2 (chip_smoke.py, the GPU tests) counts each
    instantiation of conv3x3_pair_kernel apart, and no other function."""
    from fcvsr_tpu_torch.ops import _native

    sass = "\n".join([
        "\t\tFunction : _ZN5fcvsr4pair19conv3x3_pair_kernelIfLi64EEEvPKT_",
        "  /*0450*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "  /*0460*/  FADD R3, R4, -R5 ;",
        "\t\tFunction : _ZN5fcvsr14conv3x3_kernelIfLi8ELi16ELi8ELi8EEEvPKT_",
        "  /*0450*/  FFMA R24, R4, R8, R24 ;",
        "\t\tFunction : _ZN5fcvsr4pair19conv3x3_pair_kernelIfLi32EEEvPKT_",
        "  /*0450*/  HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], R24 ;",
        "  /*0460*/  HGMMA.64x32x16.F32.BF16 R24, gdesc[UR8], R24 ;"])
    tool = tmp_path / "cuobjdump"
    tool.write_text("")
    monkeypatch.setattr(_native.shutil, "which", lambda name: str(tool))
    monkeypatch.setattr(_native.subprocess, "run", lambda cmd, **kw: type(
        "Done", (), {"stdout": sass})())
    got = _native.sass_ops("lib.so", "conv3x3_pair_kernel", ("HGMMA", "FFMA"))
    assert got == {
        "_ZN5fcvsr4pair19conv3x3_pair_kernelIfLi64EEEvPKT_":
            {"HGMMA": 1, "FFMA": 0},
        "_ZN5fcvsr4pair19conv3x3_pair_kernelIfLi32EEEvPKT_":
            {"HGMMA": 2, "FFMA": 0}}


def test_pair_ab_one_pass_edit_applies():
    """The pair A/B's one-pass edit (PERF.md's record of the route rejected)
    matches the kernel's source: the tree's kernel takes three products a
    k step for float32 maps and two for bf16, the edited copy one."""
    from fcvsr_tpu_torch.benchmarks import pair_ab
    from fcvsr_tpu_torch.ops import _native

    base = _native.edited_sources(pair_ab.SOURCE, [])[pair_ab.SOURCE]
    one = _native.edited_sources(pair_ab.SOURCE,
                                 [pair_ab.ONE_PASS])[pair_ab.SOURCE]
    assert pair_ab.ONE_PASS[0] in base and pair_ab.ONE_PASS[0] not in one
    assert one == base.replace(*pair_ab.ONE_PASS)


@pytest.mark.parametrize("cout", [64, 3, 1])
@pytest.mark.parametrize("dtype,route,bar", [
    (torch.float32, "bf16x3", CONV_RTOL), (torch.bfloat16, "bf16_w2", BF16_RTOL)])
def test_conv_route_against_float64(cout, dtype, route, bar):
    """K3's route for each storage type against the float64 conv with its
    bias, residual and leaky relu (the maps rounded to the storage type as
    the kernel reads them); bf16 output against the bar of max|out|."""
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((1, 12, 20, 64))).to(dtype)
    w = rng.standard_normal((3, 3, 64, cout)) * 0.04
    b = rng.standard_normal(cout) * 0.1
    res = _t(rng.standard_normal((1, 12, 20, cout))).to(dtype)
    ref = torch.nn.functional.leaky_relu(fused_conv._conv_plain(
        x.double(), _t(w, torch.float64), _t(b, torch.float64))
        + res.double(), 0.2)
    torch.set_num_threads(1)
    got = fused_conv.conv3x3_emulated(x, _t(w), _t(b), res, True, 0.2, route)
    assert got.dtype == dtype and got.shape == (1, 12, 20, cout)
    scale = max(1.0, float(ref.abs().max())) if dtype == torch.float32 \
        else float(ref.abs().max())
    err = float((got.double() - ref).abs().max())
    assert err <= bar * scale, (err, bar * scale)
    if dtype == torch.float32:  # and one bf16 pass does not hold it
        one = fused_conv.conv3x3_emulated(x, _t(w), _t(b), res, True, 0.2,
                                          "bf16")
        assert float((one.double() - ref).abs().max()) > bar * scale


def test_iac_ab_edits_apply(tmp_path, monkeypatch):
    """The IAC A/B's takeouts match the kernel's source, and a fake nvcc
    is handed each variant's tree, the edit applied."""
    from fcvsr_tpu_torch.benchmarks import iac_ab
    from fcvsr_tpu_torch.ops import _native

    runs = iac_ab.variants(True, None, {})
    assert list(runs) == ["base", *iac_ab.TAKEOUTS]
    base = _native.edited_sources(iac_ab.SOURCE, [])[iac_ab.SOURCE]
    for name, edits in iac_ab.TAKEOUTS.items():
        text = _native.edited_sources(iac_ab.SOURCE, edits)[iac_ab.SOURCE]
        for old, new in edits:
            assert old in base and new in text and old not in text, name
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no card here'\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_native, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no card here"):
        _native.build_variants("iac_ab", iac_ab.SOURCE, runs,
                               "fcvsr_iac_step", [])
    for name, edits in iac_ab.TAKEOUTS.items():
        written = (tmp_path / "build" / "iac_ab" / name / "iac.cu").read_text()
        assert all(new in written for _, new in edits), name


@pytest.mark.parametrize("source", ["conv3x3.cu", "microbench/conv2.cu",
                                    "iac.cu"])
def test_build_variants_writes_each_tree_and_raises_on_nvcc(
        tmp_path, monkeypatch, source):
    """Each A/B variant's tree (the source at its path under csrc/, every
    header beside csrc/'s root) is written under _build/<tool>/<name>/ and
    built by one nvcc each; a failed build raises with nvcc's output."""
    from fcvsr_tpu_torch.ops import _native

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no card here'\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_native, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no card here"):
        _native.build_variants("ab", source, {"a": [], "b": []},
                               "fcvsr_conv3x3_pair", [])
    for name in ("a", "b"):
        root = tmp_path / "build" / "ab" / name
        assert (root / source).read_text() == (_native.CSRC / source) \
            .read_text()
        assert (root / "hopper.cuh").is_file()
