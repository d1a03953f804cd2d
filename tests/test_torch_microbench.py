"""The rows-conv probes (K9) and the window-copy probes (K10) of the port
against the JAX package's, on the CPU.

The JAX scripts ``benchmarks/microbench_conv2.py`` and
``benchmarks/microbench_dma.py`` are loaded by path and run as they are
(``main`` with ``--cpu --iters 2``: their Pallas kernels in interpret mode),
with their module constants set to a small size (TH 4, C 8, WP 128, TILES
3) and ``pallas_call`` wrapped by a spy that records, through
``jax.debug.callback``, the operands and the output of each kernel's first
call.  Those operands go through the port's wrappers, which run their plain
versions on CPU tensors, and the results are held to the JAX outputs:

* K9 (``mm_stream``, ``mm_stream3``, ``im2col``, ``dma_window``) within
  1e-4 x max|JAX|: float32 sums of up to 576 bf16 values (exact products of
  bf16 operands in the mm probes) taken in another order;
* K10 (``dma_one_shot``, ``dma_serial``, ``dma_dbuf``, float32 and bf16)
  bit for bit: a copied row.  Their folds of every copied byte are held,
  bit for bit, to a fold that numpy computes from the JAX operand's bytes.

The JAX outputs are the last tile's (its kernels overwrite one block); the
port's im2col and dma_window return every tile's, and the last is compared.
Also: the port's seeded operands against the ones JAX drew, both entry
points on the CPU, their refusal without a card, the launch counters, the
wrappers' refusals, the probes' work at the real shapes and the side-library
builder without nvcc.
"""

import importlib.util
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fcvsr_tpu_torch.benchmarks import microbench_conv2 as conv2
from fcvsr_tpu_torch.benchmarks import microbench_dma as dma
from fcvsr_tpu_torch.benchmarks import microbench_common as common
from fcvsr_tpu_torch.ops import _native
from fcvsr_tpu_torch.profiling import BF16_FLOP_S, bound

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(TH=4, C=8, WP=128, TILES=3)
K9_RTOL = 1e-4
# the JAX kernels' names (their __qualname__'s last part, or the function
# that holds a `kern`) -> the port's probes
JAX_NAMES = {"mm_stream_kernel": "mm_stream",
             "mm_stream3_kernel": "mm_stream3", "im2col_kernel": "im2col",
             "dma_kernel": "dma_window", "one_shot": "dma_one_shot",
             "serial": "dma_serial", "dbuf": "dma_dbuf"}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_of(kernel) -> str:
    parts = kernel.__qualname__.split(".")
    return JAX_NAMES[parts[-1] if parts[-1] != "kern" else parts[-3]]


@pytest.fixture(scope="module")
def jax_calls():
    """{(probe, operand dtype): [operands..., output]} of each JAX kernel's
    first call, both scripts run at the small size."""
    calls = {}
    real = pl.pallas_call

    def spy(kernel, *args, **kwargs):
        call = real(kernel, *args, **kwargs)
        probe = _probe_of(kernel)

        def record(*arrays):
            key = (probe, str(arrays[0].dtype))
            calls.setdefault(key, [np.array(a) for a in arrays])

        def wrapped(*operands):
            out = call(*operands)
            jax.debug.callback(record, *operands, out)
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", spy)
        for name in ("microbench_conv2", "microbench_dma"):
            mod = _jax_script(name)
            for key, value in SMALL.items():
                mp.setattr(mod, key, value)
            mp.setattr(sys, "argv", [name, "--cpu", "--iters", "2"])
            mod.main()
    return calls


def _small(**kw):
    return dict(th=SMALL["TH"], c=SMALL["C"], wp=SMALL["WP"],
                tiles=SMALL["TILES"], **kw)


def test_jax_probes_all_ran(jax_calls):
    assert sorted(jax_calls) == sorted(
        [(p, "bfloat16") for p in ("mm_stream", "mm_stream3")]
        + [(p, "float32") for p in ("im2col", "dma_window")]
        + [(p, dt) for p in ("dma_one_shot", "dma_serial", "dma_dbuf")
           for dt in ("float32", "bfloat16")])


def test_seeded_operands_are_the_ones_jax_drew(jax_calls):
    rhs, w, src = conv2.seeded_operands(**_small())
    for probe in ("mm_stream", "mm_stream3"):
        j_rhs, j_w, _ = jax_calls[(probe, "bfloat16")]
        assert np.array_equal(rhs.float().numpy(), j_rhs.astype(np.float32))
        assert np.array_equal(w.numpy(), j_w)
    for probe in ("im2col", "dma_window"):
        assert np.array_equal(src.numpy(), jax_calls[(probe, "float32")][0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seeded_source_is_the_one_jax_drew(jax_calls, dtype):
    """K10's loop adds 1e-6 to element [0, 0, 0, 0] in the source's type
    before its first call; that element is compared apart."""
    src = dict(zip(("float32", "bfloat16"),
                   dma.seeded_source(**_small())))[dtype]
    tdt = src.dtype
    bumped = (src[0, 0, 0, 0] + torch.tensor(1e-6, dtype=tdt)).float()
    for probe in ("dma_one_shot", "dma_serial", "dma_dbuf"):
        got = jax_calls[(probe, dtype)][0].astype(np.float32)
        want = src.float().numpy().copy()
        assert got[0, 0, 0, 0] == bumped.item()
        want[0, 0, 0, 0] = got[0, 0, 0, 0]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("probe", ["mm_stream", "mm_stream3"])
def test_mm_probe_matches_jax(jax_calls, probe):
    j_rhs, j_w, j_out = jax_calls[(probe, "bfloat16")]
    rhs = torch.from_numpy(j_rhs.astype(np.float32)).to(torch.bfloat16)
    out, sums = getattr(conv2, probe)(rhs, torch.from_numpy(j_w),
                                      SMALL["TILES"])
    assert out.shape == j_out.shape == (4, 8, 128)
    err = float(np.abs(out.numpy() - j_out).max())
    assert err <= K9_RTOL * float(np.abs(j_out).max()), err
    assert sums.shape == (SMALL["TILES"],)
    assert torch.equal(sums, sums[:1].expand_as(sums))
    assert sums[0].item() == pytest.approx(float(j_out.astype(np.float64)
                                                 .sum()), rel=1e-5)


@pytest.mark.parametrize("probe", ["im2col", "dma_window"])
def test_window_probe_matches_jax(jax_calls, probe):
    j_src, j_out = jax_calls[(probe, "float32")]
    o = getattr(conv2, probe)(torch.from_numpy(j_src), SMALL["TH"])
    rows = SMALL["TH"] + (2 if probe == "dma_window" else 0)
    assert o.shape == (SMALL["TILES"], rows, SMALL["WP"])
    assert j_out.shape == (rows, SMALL["WP"])
    err = float(np.abs(o[-1].numpy() - j_out).max())
    assert err <= K9_RTOL * float(np.abs(j_out).max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("probe", ["dma_one_shot", "dma_serial", "dma_dbuf"])
def test_copy_probe_matches_jax_bit_for_bit(jax_calls, probe, dtype):
    j_src, j_out = jax_calls[(probe, dtype)]
    src = torch.from_numpy(j_src.astype(np.float32)).to(getattr(torch, dtype))
    fn = getattr(dma, probe)
    out, folds = fn(src) if probe == "dma_one_shot" else fn(src, SMALL["TH"])
    assert out.dtype == torch.float32 and j_out.dtype == np.float32
    assert np.array_equal(out.numpy(), j_out)
    th = SMALL["TH"]
    copies = [j_src[0]] if probe == "dma_one_shot" else [
        j_src[0, t * th:t * th + th + 2] for t in range(SMALL["TILES"])]
    want = np.stack([_np_fold(a) for a in copies])
    assert folds.dtype == torch.int32
    assert np.array_equal(folds.reshape(want.shape).numpy(), want)


def _np_fold(a):
    """The wrapping sum of the little-endian 32-bit words of each 1 KB of an
    array's bytes, as int32."""
    raw = np.ascontiguousarray(a).view(np.uint8).ravel()
    raw = np.pad(raw, (0, -raw.size % dma.FOLD_BYTES))
    words = raw.view("<u4").astype(np.uint64).reshape(-1, dma.FOLD_BYTES // 4)
    return (words.sum(1) % 2 ** 32).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("probe", ["dma_one_shot", "dma_serial", "dma_dbuf"])
def test_copy_probe_folds_see_every_segment(probe, dtype):
    """A copy that missed any 1 KB segment of any slab gives other folds:
    one element changed in each segment changes that segment's word and no
    other."""
    src32, src16 = dma.seeded_source(4, **_small())
    src = src32 if dtype == torch.float32 else src16
    th = SMALL["TH"]
    fn = getattr(dma, probe)
    args = () if probe == "dma_one_shot" else (th,)
    _, ref = fn(src, *args)
    per_seg = dma.FOLD_BYTES // src.element_size()  # elements a segment
    overlap = th * src.shape[2] * src.shape[3]  # slab 1's first element
    for seg in range(ref.shape[-1]):
        bumped = src.clone()
        e = seg * per_seg + 7  # an element of this segment of slab 0
        bumped[0].view(-1)[e] += 1.0
        diff = (fn(bumped, *args)[1] != ref).nonzero().tolist()
        if probe == "dma_one_shot":
            assert diff == [[seg]]
        else:  # slab 0's segment, and slab 1's where the 2 rows overlap
            assert diff == [[0, seg]] + (
                [[1, (e - overlap) // per_seg]] if e >= overlap else [])


def test_dma_window_library_matches_plain():
    """The window probe's library call, one reduce over an unfolded view,
    computes dma_window's function: within 1e-4 of max|plain| (float32 sums
    of C values in another order)."""
    _, _, src = conv2.seeded_operands(5, th=4, c=8, wp=130, tiles=3)
    got, ref = conv2.dma_window_library(src, 4), conv2.dma_window_plain(src,
                                                                        4)
    assert got.shape == ref.shape == (3, 6, 130)
    assert float((got - ref).abs().max()) <= K9_RTOL * float(ref.abs().max())


def test_conv2_main_on_cpu_runs_the_plain_versions(capsys):
    before = {f.__name__: f.launches for f in (
        conv2.mm_stream, conv2.mm_stream3, conv2.im2col, conv2.dma_window)}
    res = conv2.main(["--device", "cpu", "--th", "4", "--c", "8", "--wp",
                      "130", "--tiles", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(res["probes"]) == 4
    for rep in res["probes"]:
        assert rep["finite"] and rep["rel_dev"] == 0.0
        assert rep["ms"] is None and rep["card"] is None
        assert rep["bound_ms"] > 0
    for rep in res["probes"][:2]:
        assert rep["checksums_equal"] and rep["checksum_dev"] == 0.0
        assert len(rep["checksums"]) == 3
    assert {f.__name__: f.launches for f in (
        conv2.mm_stream, conv2.mm_stream3, conv2.im2col,
        conv2.dma_window)} == before


def test_dma_main_on_cpu_runs_the_plain_versions(capsys):
    before = [f.launches for f in (dma.dma_one_shot, dma.dma_serial,
                                   dma.dma_dbuf)]
    res = dma.main(["--device", "cpu", "--th", "4", "--c", "8", "--wp",
                    "128", "--tiles", "3"])
    assert len(capsys.readouterr().out.strip().splitlines()) == 6
    assert [(r["probe"], r["case"]) for r in res["probes"]] == [
        (p, case) for case in ("f32", "bf16")
        for p in ("dma_one_shot", "dma_serial", "dma_dbuf")]
    assert all(r["equal"] and r["ms"] is None for r in res["probes"])
    assert [f.launches for f in (dma.dma_one_shot, dma.dma_serial,
                                 dma.dma_dbuf)] == before


@pytest.mark.parametrize("mod", [conv2, dma], ids=["conv2", "dma"])
def test_main_refuses_without_cuda(mod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])


def _bad_inputs():
    rhs, w, src = conv2.seeded_operands(**_small())
    src32, src16 = dma.seeded_source(**_small())
    return {
        "rhs float32": (lambda: conv2.mm_stream(rhs.float(), w, 3), TypeError),
        "w bf16": (lambda: conv2.mm_stream3(rhs, w.bfloat16(), 3), TypeError),
        "w wrong K": (lambda: conv2.mm_stream(rhs, w[:, :-1].contiguous(), 3),
                      ValueError),
        "no tiles": (lambda: conv2.mm_stream(rhs, w, 0), ValueError),
        "WP 2": (lambda: conv2.mm_stream(rhs[..., :2].contiguous(), w, 3),
                 ValueError),
        "im2col rows": (lambda: conv2.im2col(src[:, :-1], 4), ValueError),
        "im2col bf16": (lambda: conv2.im2col(src.bfloat16(), 4), TypeError),
        "window 3-D": (lambda: conv2.dma_window(src[0], 4), ValueError),
        "one_shot int": (lambda: dma.dma_one_shot(src32.int()), TypeError),
        "serial rows": (lambda: dma.dma_serial(src16[:, :-1], 4), ValueError),
        "dbuf float64": (lambda: dma.dma_dbuf(src32.double(), 4), TypeError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrappers_refuse_bad_input(case):
    fn, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        fn()


def test_work_at_the_real_shapes():
    """The bytes, operations and bounds the probes report at TH 16, C 64,
    WP 512, 17 tiles."""
    mm = conv2.work("mm_stream")
    assert mm == conv2.work("mm_stream3") == (11_681_860, 10_267_656_192)
    assert bound(*mm, BF16_FLOP_S) == (pytest.approx(0.010382, abs=1e-6),
                                       "operations")
    assert bound(*mm)[0] == pytest.approx(0.15325, abs=1e-5)
    assert conv2.work("im2col")[0] == 36_470_784
    assert conv2.work("dma_window")[0] == 36_540_416
    assert bound(*conv2.work("im2col")) == (pytest.approx(0.010887, abs=1e-6),
                                            "bytes")
    src, folds = 35_913_728, 35_072  # float32 bytes, and its 1 KB folds
    assert dma.work("dma_one_shot", 4) == (src + 2048 + 4 * folds, src // 4)
    slabs = 17 * 18 * 64 * 512 * 4
    assert dma.work("dma_serial", 4) == dma.work("dma_dbuf", 4) == (
        src + 2048 + 4 * slabs // 1024, slabs // 4)
    assert dma.work("dma_one_shot", 2)[0] == src // 2 + 2048 + 2 * folds
    assert bound(*dma.work("dma_one_shot", 2)) == (
        pytest.approx(0.005382, abs=1e-6), "bytes")


def test_side_lib_without_nvcc_raises_and_builds_nothing(monkeypatch):
    if shutil.which("nvcc") or os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    monkeypatch.setattr(_native, "_side_libs", {})
    name = "microbench_without_nvcc"
    for _ in range(2):  # the failure is kept, and raised again
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _native.side_lib(name, common.SOURCES, common.SIGNATURES,
                             "fcvsr_mb_error_string")
    assert not (_native.BUILD_DIR / name).exists()
    assert [p.name for p in common.SOURCES] == ["conv2.cu", "dma.cu"]
