"""The rows conv kernel's time taken apart on the card (K9): the bf16 matmul
stream, the im2col build and the window copy.

    python -m fcvsr_tpu_torch.benchmarks.microbench_conv2 \\
        [--th 16 --c 64 --wp 512 --tiles 17] [--device cuda]

Counterpart of the JAX package's ``benchmarks/microbench_conv2.py``: four
probes, each over the real conv kernel's grid of ``tiles`` tiles of ``th``
rows, in its rows layout (row, channel, lane = W).  The TPU kernels write
one output block that every grid step overwrites; here every tile's work is
real and checkable:

  mm_stream   out[r] = bf16(w) @ rhs[r], (C, 9C) x (9C, WP) with float32
              sums, r < TH, for every tile; each tile's outputs summed into
              a checksum (tiles,) so that none is dead code; ``out`` written
              once.  Returns (out (TH, C, WP), checksums).
  mm_stream3  the same in 3 accumulating passes of K = 3C (dy-major columns
              of w, rows of rhs), as the cat3 conv variant multiplies.
  im2col      o[t, r, x] = sum over dy, dx < 3 and c of
              f32(bf16(src[0, t*TH + r + dy, c, (x + dx) mod WP])): the
              window copy, the build of the bf16 (9C, WP) operand and a
              reduce; (tiles, TH, WP).  The JAX output is o[-1].
  dma_window  o[t, r, x] = sum_c src[0, t*TH + r, c, x], r < TH + 2: the
              window copy and a reduce; (tiles, TH + 2, WP).  The JAX output
              is o[-1].

Each wrapper launches its kernel (``csrc/microbench/conv2.cu``) on a CUDA
tensor, or raises; on a CPU tensor it runs its plain version.
``<wrapper>.launches`` counts the launches.  The operands are drawn from
seed 0 in the JAX script's order (:func:`seeded_operands`).

The window probes' kernel replaces the TPU's ``im2col_kernel`` and
``dma_kernel`` (``:107, 140``) with a persistent TMA stream: one block an
SM takes units of (source row, 64 lanes; fewer for C > 64) in turn, each
unit's C channels one TMA box from a float32 tensor map into a ring of 12
stages on mbarriers, summed over the channels by four consumer warps; each
source row is read once.  dma_window writes the sums into the one or two
windows that hold the row; im2col sums the bf16-rounded rows into a (tiles
* TH + 2, WP) scratch and, after a grid barrier in the same cooperative
launch, takes their 3x3 box with the lanes wrapping
(:func:`im2col_boxsum_emulated` is that route on the CPU): no (9C, WP)
operand is built, as K2 builds none on Hopper.  It takes WP a multiple of
4 (TMA's 16-byte row stride) and C <= 256 (a box's rows) on a CUDA tensor
(else ValueError).

The mm probes' kernel replaces the TPU's ``mm_stream_kernel`` and
``mm_stream3_kernel`` (``benchmarks/microbench_conv2.py:62, 82``) with
Hopper's warpgroup MMA (``wgmma``, bf16, float32 sums) fed by TMA: one
persistent block an SM rounds w to bf16 into shared memory once; two
consumer warpgroups take its units of work in turn (tile, row, 128 lanes;
64 in the last round, so that no SM takes a whole item more than
another), each fed through its own ring of 4 swizzled stages on
mbarriers by a producer lane.  mm_stream3 runs the same kernel: one
float32 accumulator takes its three passes in turn.  It takes C = 64 (one
wgmma m64 tile) and, on a CUDA tensor, WP a multiple of 8 (TMA's 16-byte
row stride).  Its bound is the operations' (0.0104 ms at the real shape),
but since it stands for K2, where every tile's operand differs, each tile
reads its rhs again: 17 x 9.4 MB through L2, and each SM's intake of those
bytes is what holds it; the report gives that rate beside the TFLOP/s.

On a CUDA device each probe is checked against its plain version and timed
with CUDA events: the mm probes warm (their fixed rhs is resident by design,
as the TPU kept it in VMEM: 50 launches between one event pair; the kernel
and its library call in turns, the median of 3 each), the window
probes cold (the 35.9 MB source fits in the 50 MB L2: a 128 MiB write, read
back, before each launch, the median of 30).  One JSON line a probe: the
card's name and power limit, the kernel's ms and TFLOP/s or GB/s, the least
time the card could take (:func:`work`, ``profiling.bound``; the mm probes
at the bf16 tensor-core rate, with the float32 pipes' beside it) and the
kernel's share of it, the plain version's ms, the library call's ms and its
deviation from the plain version, and the max deviation of the kernel from
the plain version; the mm probes also the L2 bytes their kernel reads
(every tile's rhs, and w once a block) and that rate.  The library calls
compute the same function in one call: for the mm probes ``torch.bmm`` of
the bf16 weights by the tile's rhs
(576, TH*WP), both expanded over the tiles with a stride of 0, so that
cuBLAS reads the rhs from L2 as the kernel does (but writes every tile's
output: its own bound beside it); the repeated rhs of 160 MB that cuBLAS
reads from HBM stands beside it as a yardstick with its bound; for
dma_window ``src[0].unfold(0, TH + 2, TH).sum(1)``, one reduce over a view,
with ``dst.copy_(src)`` as the copy-rate yardstick; im2col has none.
``--device cpu`` runs the plain versions and times nothing; without a card
the default ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from ..ops import _native
from ..profiling import BF16_FLOP_S, bound, card, need_device
from . import microbench_common as common

__all__ = ["TH", "C", "WP", "TILES", "seeded_operands", "mm_stream",
           "mm_stream3", "im2col", "dma_window", "mm_stream_plain",
           "mm_stream3_plain", "im2col_plain", "im2col_boxsum_emulated",
           "dma_window_plain", "work",
           "mm_l2_bytes", "main"]

TH, C, WP, TILES = 16, 64, 512, 17
REPLACES = {"mm_stream": "benchmarks/microbench_conv2.py:62",
            "mm_stream3": "benchmarks/microbench_conv2.py:82",
            "im2col": "benchmarks/microbench_conv2.py:107",
            "dma_window": "benchmarks/microbench_conv2.py:140"}
MM_C = 64  # the mm kernel's output channels (the wgmma tile's M)
MM_LANES = 128  # output lanes a work item of the mm kernel (the wgmma N)
MM_WP_STEP = 8  # the kernel's WP is a multiple of this: TMA's row stride
WIN_WP_STEP = 4  # the window kernel's: TMA's 16-byte row stride in float32
WIN_MAX_C = 256  # the window kernel's channels at most: a TMA box's rows


def seeded_operands(seed: int = 0, th: int = TH, c: int = C, wp: int = WP,
                    tiles: int = TILES):
    """(rhs (th, 9c, wp) bf16, w (c, 9c) float32, src (1, tiles*th + 2, c,
    wp) float32) on the CPU, uniform(-1, 1) from ``seed`` in the JAX
    script's order."""
    rng = np.random.default_rng(seed)
    rhs = torch.from_numpy(rng.uniform(-1, 1, (th, 9 * c, wp))).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-1, 1, (c, 9 * c)).astype(np.float32))
    src = torch.from_numpy(rng.uniform(
        -1, 1, (1, tiles * th + 2, c, wp)).astype(np.float32))
    return rhs, w, src


def _check_mm(rhs, w, tiles: int):
    if rhs.dim() != 3 or w.dim() != 2:
        raise ValueError(f"rhs must be (TH, 9C, WP) and w (C, 9C), got "
                         f"{tuple(rhs.shape)} and {tuple(w.shape)}")
    th, _, wp = rhs.shape
    c = w.shape[0]
    _native.require(rhs, "rhs", rhs.device, (th, 9 * c, wp), torch.bfloat16)
    _native.require(w, "w", rhs.device, (c, 9 * c), torch.float32)
    if tiles < 1 or wp < 3:
        raise ValueError(f"need tiles >= 1 and WP >= 3, got {tiles}, {wp}")


def _mm_plain(rhs, w, tiles: int, passes: int):
    """Every tile's product in float32 sums of bf16 operands, ``passes``
    accumulating passes over K; its checksum is the sum of its outputs."""
    _check_mm(rhs, w, tiles)
    wb, x = w.to(torch.bfloat16).float(), rhs.float()
    k = wb.shape[1] // passes
    sums = []
    for _ in range(tiles):
        out = torch.zeros(rhs.shape[0], w.shape[0], rhs.shape[2],
                          device=rhs.device)
        for p in range(passes):
            out = out + torch.matmul(wb[:, p * k:(p + 1) * k],
                                     x[:, p * k:(p + 1) * k])
        sums.append(out.double().sum())
    return out, torch.stack(sums).float()


def mm_stream_plain(rhs, w, tiles: int = TILES):
    """(out (TH, C, WP) float32, checksums (tiles,)): out[r] = bf16(w) @
    rhs[r] in float32 sums, computed for each tile."""
    return _mm_plain(rhs, w, tiles, 1)


def mm_stream3_plain(rhs, w, tiles: int = TILES):
    """:func:`mm_stream_plain` in 3 accumulating passes of K = 3C."""
    return _mm_plain(rhs, w, tiles, 3)


def _mm(rhs, w, tiles: int, what: str):
    _check_mm(rhs, w, tiles)
    th, _, wp = rhs.shape
    if w.shape[0] != MM_C:
        raise ValueError(f"the mm kernel takes C = {MM_C}, got {w.shape[0]}")
    if wp % MM_WP_STEP:
        raise ValueError(f"the mm kernel takes WP a multiple of "
                         f"{MM_WP_STEP} (TMA's 16-byte row stride), got {wp}")
    dev = rhs.device
    out = torch.empty(th, MM_C, wp, device=dev)
    sums = torch.empty(tiles, device=dev)
    partials = torch.empty(tiles * th * -(-wp // MM_LANES) * 2, device=dev)
    counters = torch.zeros(tiles, dtype=torch.int32, device=dev)
    lib = common.lib()
    with _native.launch_guard(rhs) as stream:
        rc = lib.fcvsr_mb_mm_stream(
            rhs.data_ptr(), w.data_ptr(), out.data_ptr(), sums.data_ptr(),
            partials.data_ptr(), counters.data_ptr(), th, wp, tiles, stream)
    _native.check_side(lib, rc, what)
    return out, sums


def mm_stream(rhs, w, tiles: int = TILES):
    """The mm_stream kernel (``wgmma`` bf16, float32 sums, rhs by TMA) on a
    CUDA tensor, :func:`mm_stream_plain` on a CPU tensor.  rhs (TH, 576,
    WP) bf16, WP a multiple of 8 on a CUDA tensor (else ValueError), w (64,
    576) float32, both 16-byte aligned (or the launch fails).  Each call
    zeroes the tiles' counters the kernel's blocks count off on (one memset
    before the launch)."""
    if _native.on_cpu(rhs):
        return mm_stream_plain(rhs, w, tiles)
    got = _mm(rhs, w, tiles, "mm_stream")
    mm_stream.launches += 1
    return got


def mm_stream3(rhs, w, tiles: int = TILES):
    """:func:`mm_stream` in 3 accumulating passes of K = 192.  The kernel
    is mm_stream's: its one float32 accumulator takes the three passes in
    turn (a second one for each pass's dot, added at the pass's end as the
    TPU kernel adds, held the tolerance too but ran 1.1% to 1.4% slower on
    the H100)."""
    if _native.on_cpu(rhs):
        return mm_stream3_plain(rhs, w, tiles)
    got = _mm(rhs, w, tiles, "mm_stream3")
    mm_stream3.launches += 1
    return got


def _tiles(src, th: int) -> int:
    """The tiles of a rows-layout source (1, tiles*th + 2, C, WP)."""
    if src.dim() != 4 or src.shape[0] != 1:
        raise ValueError(f"src must be (1, tiles*TH + 2, C, WP), got "
                         f"{tuple(src.shape)}")
    rows, wp = src.shape[1], src.shape[3]
    tiles = (rows - 2) // th if th >= 1 else 0
    if tiles < 1 or rows != tiles * th + 2 or wp < 3:
        raise ValueError(f"src {tuple(src.shape)}: need tiles * {th} + 2 "
                         "rows for some tiles >= 1, and WP >= 3")
    return tiles


def _check_window(src, th: int) -> int:
    tiles = _tiles(src, th)
    _native.require(src, "src", src.device, dtype=torch.float32)
    return tiles


def im2col_plain(src, th: int = TH):
    """o (tiles, TH, WP): each tile's window rounded to bf16, rolled by 0, 1
    and 2 lanes (wrapping), the 9 (dy, dx) slabs stacked into the (9C, WP)
    operand of each row, summed over it in float32."""
    tiles = _check_window(src, th)
    xb = src[0].to(torch.bfloat16)
    outs = []
    for t in range(tiles):
        win = xb[t * th:t * th + th + 2]
        rolled = [win.roll(-dx, dims=-1) for dx in range(3)]
        rhs = torch.cat([rolled[dx][dy:dy + th] for dy in range(3)
                         for dx in range(3)], dim=1)
        outs.append(rhs.float().sum(dim=1))
    return torch.stack(outs)


def im2col_boxsum_emulated(src, th: int = TH):
    """im2col's function by its kernel's route on the card: the channel
    sums of every bf16-rounded source row, s[p, x] = sum_c
    f32(bf16(src[0, p, c, x])), then their 3x3 box, o[t, r, x] = sum over
    dy, dx < 3 of s[t*TH + r + dy, (x + dx) mod WP]; (tiles, TH, WP).  No
    (9C, WP) operand is built."""
    tiles = _check_window(src, th)
    s = src[0].to(torch.bfloat16).float().sum(dim=1)
    h = s + s.roll(-1, dims=-1) + s.roll(-2, dims=-1)
    return (h[:-2] + h[1:-1] + h[2:]).reshape(tiles, th, -1)


def dma_window_plain(src, th: int = TH):
    """o (tiles, TH + 2, WP): each tile's window summed over the
    channels."""
    tiles = _check_window(src, th)
    return torch.stack([src[0, t * th:t * th + th + 2].sum(dim=1)
                        for t in range(tiles)])


def _window(src, th: int, build: bool, lib=None):
    tiles = _check_window(src, th)
    c, wp = src.shape[2], src.shape[3]
    if wp % WIN_WP_STEP:
        raise ValueError(f"the window kernel takes WP a multiple of "
                         f"{WIN_WP_STEP} (TMA's 16-byte row stride), got {wp}")
    if c > WIN_MAX_C:
        raise ValueError(f"the window kernel takes C <= {WIN_MAX_C} (a TMA "
                         f"box's rows), got {c}")
    out = torch.empty(tiles, th if build else th + 2, wp, device=src.device)
    # im2col's channel sums of every source row, for the 3x3 box
    sums = torch.empty(tiles * th + 2, wp, device=src.device) if build \
        else None
    lib = lib or common.lib()
    with _native.launch_guard(src) as stream:
        rc = lib.fcvsr_mb_window(src.data_ptr(), out.data_ptr(),
                                 _native.ptr(sums), th, c, wp, tiles,
                                 int(build), stream)
    _native.check_side(lib, rc, "im2col" if build else "dma_window")
    return out


def im2col(src, th: int = TH):
    """The im2col kernel on a CUDA tensor, :func:`im2col_plain` on a CPU
    tensor.  src (1, tiles*TH + 2, C, WP) float32."""
    if _native.on_cpu(src):
        return im2col_plain(src, th)
    out = _window(src, th, True)
    im2col.launches += 1
    return out


def dma_window(src, th: int = TH):
    """The window kernel on a CUDA tensor, :func:`dma_window_plain` on a CPU
    tensor.  src (1, tiles*TH + 2, C, WP) float32."""
    if _native.on_cpu(src):
        return dma_window_plain(src, th)
    out = _window(src, th, False)
    dma_window.launches += 1
    return out


for _fn in (mm_stream, mm_stream3, im2col, dma_window):
    _fn.launches = 0


def work(probe: str, th: int = TH, c: int = C, wp: int = WP,
         tiles: int = TILES):
    """(bytes, flops) of a probe: each input read once and each output
    written once; 2 flops a multiply-add of the mm probes, one an add of the
    window reduces."""
    src = (tiles * th + 2) * c * wp * 4
    if probe in ("mm_stream", "mm_stream3"):
        return (th * 9 * c * wp * 2 + c * 9 * c * 4 + th * c * wp * 4
                + tiles * 4, 2 * tiles * th * 9 * c * c * wp)
    if probe == "im2col":
        return src + tiles * th * wp * 4, tiles * th * wp * 9 * c
    if probe == "dma_window":
        return src + tiles * (th + 2) * wp * 4, tiles * (th + 2) * wp * c
    raise ValueError(f"unknown probe {probe!r}")


def mm_l2_bytes(th: int = TH, c: int = C, wp: int = WP, tiles: int = TILES,
                blocks: int = 0):
    """(rhs bytes, w bytes) the mm kernel reads through L2: every tile's
    rhs, which each tile streams anew as K2's tiles each read their own
    operand (17 x 9.4 MB at the real shape), and the float32 w once for
    each of its ``blocks`` persistent blocks."""
    return tiles * th * 9 * c * wp * 2, blocks * c * 9 * c * 4


def _mm_blocks(dev, th: int = TH, wp: int = WP, tiles: int = TILES) -> int:
    """The mm kernel's grid on ``dev``: one block an SM (its shared memory
    allows no second), no more than the 64-lane halves of its items."""
    halves = 2 * tiles * th * -(-wp // MM_LANES)
    return min(halves, torch.cuda.get_device_properties(dev)
               .multi_processor_count)


def dma_window_library(src, th: int = TH):
    """dma_window's function in one PyTorch call, a channel sum over an
    unfolded view: (tiles, TH + 2, WP), transposed in place."""
    return src[0].unfold(0, th + 2, th).sum(1).transpose(1, 2)


def _rel(got, ref) -> float:
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / scale if scale else float("inf")


@torch.no_grad()
def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--th", type=int, default=TH)
    parser.add_argument("--c", type=int, default=C)
    parser.add_argument("--wp", type=int, default=WP)
    parser.add_argument("--tiles", type=int, default=TILES)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    dev = need_device(args.device)
    cuda = dev.type == "cuda"
    th, c, wp, tiles = args.th, args.c, args.wp, args.tiles
    shape = dict(th=th, c=c, wp=wp, tiles=tiles)
    rhs, w, src = (t.to(dev) for t in seeded_operands(**shape))
    gpu = card() if cuda else None
    probes = {
        "mm_stream": (lambda: mm_stream(rhs, w, tiles),
                      lambda: mm_stream_plain(rhs, w, tiles)),
        "mm_stream3": (lambda: mm_stream3(rhs, w, tiles),
                       lambda: mm_stream3_plain(rhs, w, tiles)),
        "im2col": (lambda: im2col(src, th), lambda: im2col_plain(src, th)),
        "dma_window": (lambda: dma_window(src, th),
                       lambda: dma_window_plain(src, th)),
    }
    if cuda:
        # the mm library call's operands: the bf16 weights and the rhs as
        # (9C, TH*WP), both expanded over the tiles with a stride of 0; the
        # yardstick's, the rhs repeated over the tiles (160 MB)
        x = rhs.permute(1, 0, 2).reshape(9 * c, th * wp)
        wb = w.to(torch.bfloat16)
        wb_t, x_t = wb.expand(tiles, c, 9 * c), x.expand(tiles, 9 * c,
                                                        th * wp)
        x_rep = x.repeat(1, tiles)
        mm_lib = (lambda: torch.bmm(wb_t, x_t, out_dtype=torch.float32),
                  lambda: torch.matmul(wb, x_rep))
    reports = []
    for name, (kern, plain) in probes.items():
        mm = name.startswith("mm")
        got, ref = kern(), plain()
        if mm:
            (got, sums), (ref, ref_sums) = got, ref
        dev_max = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        nbytes, flops = work(name, **shape)
        bound_ms, bound_by = (bound(nbytes, flops, BF16_FLOP_S) if mm
                              else bound(nbytes, flops))
        rep = dict(probe=name, replaces=REPLACES[name], shape=shape,
                   device=str(dev), card=gpu,
                   finite=bool(torch.isfinite(got).all()),
                   max_abs_dev=dev_max, max_abs_plain=scale,
                   rel_dev=dev_max / scale if scale else float("inf"),
                   bytes=nbytes, flops=flops, bound_ms=bound_ms,
                   bound_by=bound_by, ms=None, plain_ms=None,
                   library_ms=None, library_rel_dev=None, bound_share=None)
        if mm:
            sums_l = [float(v) for v in sums.cpu()]
            out_bytes = tiles * c * th * wp
            l2_rhs, l2_w = mm_l2_bytes(
                **shape, blocks=_mm_blocks(dev, th, wp, tiles) if cuda else 0)
            rep.update(
                l2_bytes=l2_rhs, l2_w_bytes=l2_w, l2_gbps=None,
                f32_pipes_bound_ms=bound(nbytes, flops)[0],
                checksums=sums_l, checksum_plain=float(ref_sums[0]),
                checksums_equal=len(set(sums_l)) == 1,
                checksums_finite=all(np.isfinite(sums_l)),
                checksum_dev=max(abs(v - float(ref_sums[0]))
                                 for v in sums_l),
                checksum_tol=1e-4 * float(ref.double().abs().sum()),
                library=f"torch.bmm, bf16 ({tiles}, {c}, {9 * c}) x "
                f"({tiles}, {9 * c}, {th * wp}) expanded with stride 0, "
                "float32 out",
                library_bound_ms=bound(
                    th * 9 * c * wp * 2 + c * 9 * c * 2 + out_bytes * 4,
                    flops, BF16_FLOP_S)[0],
                yardstick=f"torch.matmul, bf16 ({c}, {9 * c}) x "
                f"({9 * c}, {tiles * th * wp}), the rhs repeated, bf16 out",
                yardstick_ms=None,
                yardstick_bound_ms=bound(
                    tiles * 9 * c * th * wp * 2 + c * 9 * c * 2
                    + out_bytes * 2, flops, BF16_FLOP_S)[0])
        elif name == "dma_window":
            rep.update(library=f"src[0].unfold(0, {th + 2}, {th}).sum(1), "
                       "a reduce over a view",
                       yardstick="dst.copy_(src)", yardstick_ms=None)
        else:
            rep.update(library="none: no single call",
                       yardstick="dst.copy_(src)", yardstick_ms=None)
        if cuda:
            if mm:
                lib_out = mm_lib[0]()
                rep["library_rel_dev"] = _rel(
                    lib_out[-1].reshape(c, th, wp).permute(1, 0, 2), ref)
                del lib_out
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                mm_lib[0]()
                # above the output: what a copy of the expanded operands
                # would take (0: cuBLAS reads them in place)
                rep["library_extra_bytes"] = (
                    torch.cuda.max_memory_allocated() - base
                    - out_bytes * 4)
                # the kernel and the library call in turns (K L L K K L),
                # the median of each: the two are within a few per cent,
                # and one pair alone moves as much between probes
                runs = {kern: [], mm_lib[0]: []}
                for fn in (kern, mm_lib[0], mm_lib[0], kern, kern,
                           mm_lib[0]):
                    runs[fn].append(common.warm_ms(fn))
                rep["ms_runs"], rep["library_ms_runs"] = runs.values()
                rep["ms"] = statistics.median(runs[kern])
                rep["library_ms"] = statistics.median(runs[mm_lib[0]])
                rep["plain_ms"] = common.warm_ms(plain, 5)
                rep["yardstick_ms"] = common.warm_ms(mm_lib[1])
                rep["tflops"] = flops / rep["ms"] * 1e-9
                rep["l2_gbps"] = (l2_rhs + l2_w) / rep["ms"] * 1e-6
                rep["timing"] = (f"warm, a spin then {common.WARM_ITERS}"
                                 " launches an event pair; kernel and "
                                 "library in turns, the median of 3")
            else:
                dst = torch.empty_like(src)
                rep["ms"] = common.cold_ms(kern)
                rep["plain_ms"] = common.cold_ms(plain)
                if name == "dma_window":
                    rep["library_rel_dev"] = _rel(
                        dma_window_library(src, th), ref)
                    rep["library_ms"] = common.cold_ms(
                        lambda: dma_window_library(src, th))
                rep["yardstick_ms"] = common.cold_ms(lambda: dst.copy_(src))
                rep["gbps"] = nbytes / rep["ms"] * 1e-6
                rep["timing"] = (f"cold, 128 MiB written and read back and "
                                 f"a spin before each launch, median of "
                                 f"{common.COLD_REPS}")
            rep["bound_share"] = bound_ms / rep["ms"]
        print(json.dumps(rep), flush=True)
        reports.append(rep)
    return {"probes": reports}


if __name__ == "__main__":
    main()
