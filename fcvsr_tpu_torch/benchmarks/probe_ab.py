"""An A/B of the window probes (K9's im2col and dma_window,
``csrc/microbench/conv2.cu``) and the window-copy probes (K10,
``csrc/microbench/dma.cu``) against edited copies of themselves and
against another checkout's, cold, on the card.

    python -m fcvsr_tpu_torch.benchmarks.probe_ab [--takeouts] \\
        [--parent DIR] ['{"name": [[old, new], ...]}'] \\
        [--group window copy] [--rounds 3] [--steps 1 2 4 8 17]

A variant is the tree's source with each ``old`` text replaced by ``new``
(``["hopper.cuh", old, new]`` edits the header), or a directory's path,
whose source and headers are built instead, or ``{"dir": DIR, "edits":
[...]}``, that directory's files edited (``_native.edited_sources``); a
JSON variant edits the sources of every group asked for.
``--takeouts`` or a JSON variant adds the tree's kernels (``base``);
``--takeouts`` also the edits that take a piece out (:data:`TAKEOUTS`).  ``--parent DIR`` adds another
checkout's ``csrc/`` (``parent``; its window entry point as it was before
the redesign, without the scratch), and with ``--takeouts`` the edits of
:data:`PARENT_TAKEOUTS` to it (``parent_<name>``: the kernels before the
redesign taken apart); ``--no-tree`` leaves the tree's kernels out.  An
edit whose ``old`` text is missing raises.  nvcc builds every variant of a group at once into a library of
its own under ``_build/probe_ab/<group>_<name>/``
(``_native.build_variants``).

The probes run at their real shape (17 tiles of 16 rows, C 64, WP 512;
the copies in float32 and bf16), from the probes' seeded operands.  Each
variant runs once and is held to the plain version (the window probes'
max deviation over max|plain|, beside the bar 1e-4; the copies' row and
folds bit for bit; a takeout may miss them), then every variant is timed
cold (``microbench_common.cold_ms``: the L2 flushed before each launch,
the median of 30) in ``--rounds`` rounds, the variants in turns, forwards
and backwards by round.  One JSON line a variant, probe and type: the
median of the rounds' ms and every round's.  ``--steps`` also times
every variant's ``dma_window``, ``dma_serial`` and ``dma_one_shot`` on
the source's first tiles at those tile counts and prints the
least-squares ms a tile, the intercept, and the rate a tile adds, in GB/s
and GB/s an SM: a serial step is one share's round trip plus what the
block does before it issues the next, and the two streams' rate is what
a window of rows costs to stream into an SM.  A CUDA device is needed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics

import numpy as np
import torch

from ..ops import _native
from ..profiling import card, need_device
from . import microbench_common as common
from . import microbench_conv2 as conv2
from . import microbench_dma as dma

__all__ = ["SOURCES", "PROBES", "TAKEOUTS", "PARENT_TAKEOUTS", "variants",
           "main"]

SOURCES = {"window": "microbench/conv2.cu", "copy": "microbench/dma.cu"}
PROBES = {"window": ("im2col", "dma_window"),
          "copy": ("dma_one_shot", "dma_serial", "dma_dbuf")}
BAR = 1e-4
_P, _I = ctypes.c_void_p, ctypes.c_int
# the kernels of before the redesign (a --parent checkout's) with a piece
# taken out, a group's: the window kernel's two halo lanes, its operand
# build and the barriers around it, its second block an SM; the one-shot
# copy's blocks set to a whole number of waves; the slab copies' fold,
# their row stores, their 1024-thread barrier (an mbarrier each buffer
# that the warps arrive on and thread 0 waits on), and all three (what is
# left is a step's round trip)
_SERIAL_SYNC = ("      fold(folds + t * segs, buf[0], lo, bytes);\n"
                "      __syncthreads();  // the buffer is free for slab t + 1")
_DBUF_SYNC = ("      fold(folds + t * segs, buf[t & 1], lo, bytes);\n"
              "      __syncthreads();")
_MBAR_INIT = ["    mbar_init(&bar[1], 1);\n",
              "    mbar_init(&bar[1], 1);\n"
              "    mbar_init(&bar[2], kDmaThreads / 32);\n"
              "    mbar_init(&bar[3], kDmaThreads / 32);\n"]
_MBAR_SERIAL = [_SERIAL_SYNC,
                "      fold(folds + t * segs, buf[0], lo, bytes);\n"
                "      __syncwarp();\n"
                "      fcvsr::sm90::mbar_arrive(&bar[2], (threadIdx.x & 31) == 0);\n"
                "      if (threadIdx.x == 0) mbar_wait(&bar[2], t & 1);"]
_MBAR_DBUF = [
    ["      if (threadIdx.x == 0 && t + 1 < tiles)\n",
     "      if (threadIdx.x == 0 && t >= 1 && t + 1 < tiles)\n"
     "        mbar_wait(&bar[2 + ((t + 1) & 1)], ((t - 1) >> 1) & 1);\n"
     "      if (threadIdx.x == 0 && t + 1 < tiles)\n"],
    [_DBUF_SYNC,
     "      fold(folds + t * segs, buf[t & 1], lo, bytes);\n"
     "      __syncwarp();\n"
     "      fcvsr::sm90::mbar_arrive(&bar[2 + (t & 1)], (threadIdx.x & 31) == 0);"]]
_NO_FOLD = [["      fold(folds + t * segs, buf[t & 1], lo, bytes);\n", ""],
            ["      fold(folds + t * segs, buf[0], lo, bytes);\n", ""]]
_NO_ROW = [["      store_row(out, buf[t & 1], lo, bytes, WP, bf16);\n", ""],
           ["      store_row(out, buf[0], lo, bytes, WP, bf16);\n", ""]]
PARENT_TAKEOUTS = {
    "window": {
        "no_halo": [["for (int q = tid; q < lines * 6; q += kWinThreads) {\n"
                     "      const int line = q / 6, part = q % 6;",
                     "for (int q = tid; q < lines * 4; q += kWinThreads) {\n"
                     "      const int line = q / 4, part = q % 4;"]],
        "no_build": [
            ["        ol[c * kSW] = __float2bfloat16_rn(x < nout ? wl[c * kLine] : 0.f);",
             "        if (c < 0) ol[c * kSW] = __float2bfloat16_rn(wl[c * kLine]);"],
            ["    __syncthreads();\n    // its sum over k", "    // its sum over k"],
            ["    red[tid] = s;\n    __syncthreads();", "    red[tid] = s;"],
            ["    __syncthreads();  // op and red are free for the next row", ""]],
        "one_block": [["const size_t smem = window_smem(TH, C, kBuild);",
                       "const size_t smem = window_smem(TH, C, kBuild) + 100 * 1024;"]],
    },
    "copy": {
        "whole_waves": [["  if (chunk > total) chunk = total;\n",
                         "  if (chunk > total) chunk = total;\n"
                         "  {  // the fewest whole waves of one block an SM\n"
                         "    int d = 0, s = 0;\n"
                         "    cudaGetDevice(&d);\n"
                         "    cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, d);\n"
                         "    for (long long k = 1;; ++k) {\n"
                         "      const long long c2 = ((total + k * s - 1) / (k * s) + kFold - 1) / kFold * kFold;\n"
                         "      if (c2 <= chunk) { chunk = c2; break; }\n"
                         "    }\n"
                         "  }\n"]],
        "no_fold": _NO_FOLD,
        "no_row": _NO_ROW,
        "mbarrier": [_MBAR_INIT, _MBAR_SERIAL, *_MBAR_DBUF],
        "bare": [_MBAR_INIT, _MBAR_SERIAL, *_MBAR_DBUF, *_NO_FOLD, *_NO_ROW],
    },
}
# the tree's kernels with a piece taken out: the window kernel's channel
# sums (the stream alone), im2col's grid barrier and 3x3 box; the copies'
# fold (the stream and the row)
TAKEOUTS = {
    "window": {
        "no_sum": [["      for (int c = part; c < C; c += kParts) {",
                    "      for (int c = part; c < 0; c += kParts) {"]],
        "no_box": [["    cooperative_groups::this_grid().sync();  // every row's sums, in L2\n"
                    "    window_box(out, sums, TH, WP, tiles);\n", ""]],
    },
    "copy": {
        "no_fold": [["const unsigned word = fold_segment(buf + g * kFold, bytes, lane);",
                     "const unsigned word = bytes;"]],
    },
}
# which probes a variant changes (the others run its base kernel's code)
TAKEOUT_PROBES = {
    "parent_no_halo": ("im2col", "dma_window"), "parent_no_build": ("im2col",),
    "parent_one_block": ("im2col", "dma_window"),
    "parent_whole_waves": ("dma_one_shot",), "no_box": ("im2col",),
    **dict.fromkeys(("parent_no_fold", "parent_no_row", "parent_mbarrier",
                     "parent_bare"), ("dma_serial", "dma_dbuf"))}
# the window entry point before the redesign, which took no scratch
PARENT_WINDOW = [_P, _P] + [_I] * 5 + [_P]


def variants(takeouts: bool, parent: str | None, extra: dict, group: str,
             tree: bool = True) -> dict:
    """{name: edits} of a group's runs (see the module's note)."""
    out = {}
    if (takeouts or extra) and tree:
        out["base"] = []
    if takeouts and tree:
        out.update(TAKEOUTS[group])
    if parent:
        out["parent"] = parent
        if takeouts:
            out.update({f"parent_{name}": {"dir": parent, "edits": edits}
                        for name, edits in PARENT_TAKEOUTS[group].items()})
    out.update(extra)
    return out


def _bind(handle, parent: bool):
    """The probes' entry points of a variant's library, typed (a parent's
    window entry point as it was before the redesign)."""
    for name, argtypes in common.SIGNATURES.items():
        fn = getattr(handle, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    if parent and hasattr(handle, "fcvsr_mb_window"):
        handle.fcvsr_mb_window.argtypes = PARENT_WINDOW
    # dma.cu alone has no error string of its own
    err = getattr(handle, "fcvsr_mb_error_string", None)
    if err is not None:
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    handle.error_string = err or (lambda rc: b"see cudaGetErrorString")
    return handle


def _parent_window(lib, src, th: int, build: bool):
    """The window kernel before the redesign, called as its wrapper did."""
    tiles = conv2._check_window(src, th)
    c, wp = src.shape[2], src.shape[3]
    out = torch.empty(tiles, th if build else th + 2, wp, device=src.device)
    with _native.launch_guard(src) as stream:
        rc = lib.fcvsr_mb_window(src.data_ptr(), out.data_ptr(), th, c, wp,
                                 tiles, int(build), stream)
    _native.check_side(lib, rc, "parent window")
    return out


class _Call:
    """A call of a variant's kernel on ``src``; ``on(other)`` calls it on
    another source of the same kind."""

    def __init__(self, fn, src):
        self.fn, self.src = fn, src

    def __call__(self):
        return self.fn(self.src)

    def on(self, src):
        return self.fn(src)


def _calls(group: str, lib, parent: bool, src, src16=None):
    """{(probe, type): a call of the variant's kernel}."""
    th = conv2.TH
    if group == "window":
        win = _parent_window if parent else \
            lambda lib, s, th, build: conv2._window(s, th, build, lib)
        return {("im2col", "f32"): _Call(lambda s: win(lib, s, th, True), src),
                ("dma_window", "f32"): _Call(lambda s: win(lib, s, th, False),
                                             src)}
    out = {}
    for case, s in (("f32", src), ("bf16", src16)):
        out[("dma_one_shot", case)] = _Call(lambda s: dma._one_shot(s, lib), s)
        out[("dma_serial", case)] = _Call(
            lambda s: dma._slabs(s, th, False, lib), s)
        out[("dma_dbuf", case)] = _Call(lambda s: dma._slabs(s, th, True, lib),
                                        s)
    return out


def _plain(probe: str, src):
    th = conv2.TH
    return {"im2col": lambda: conv2.im2col_plain(src, th),
            "dma_window": lambda: conv2.dma_window_plain(src, th),
            "dma_one_shot": lambda: dma.dma_one_shot_plain(src),
            "dma_serial": lambda: dma.dma_serial_plain(src, th),
            "dma_dbuf": lambda: dma.dma_dbuf_plain(src, th)}[probe]()


def _held(probe: str, got, ref) -> dict:
    if probe in PROBES["window"]:
        rel = float((got - ref).abs().max() / ref.abs().max())
        return dict(rel_dev=rel, held=rel <= BAR)
    (row, folds), (ref_row, ref_folds) = got, ref
    eq = bool(torch.equal(row, ref_row) and torch.equal(folds, ref_folds))
    return dict(equal=eq, held=eq,
                folds_differing=int((folds != ref_folds).sum()))


def _slope(xs, ys):
    a = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)
    return float(a[0]), float(a[1])


# the probes --steps times at several tile counts: a serial step, and the
# rate of the two streams (a tile adds TH rows of the source)
STEP_PROBES = {"window": ("dma_window",), "copy": ("dma_serial", "dma_one_shot")}


def _steps(group: str, calls: dict, steps, gpu: str) -> list:
    """One line a variant, probe and type: the cold ms at each tile count
    of ``steps`` (the source's first tiles * TH + 2 rows), the least-squares
    ms a tile and the intercept, and the bytes a tile over the ms a tile,
    on the card and a tile's SMs (GB/s an SM)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lines = []
    for name, fns in calls.items():
        for (probe, case), fn in fns.items():
            if probe not in STEP_PROBES[group]:
                continue
            src = fn.src
            ms = []
            for t in steps:
                part = src[:, :t * conv2.TH + 2].contiguous()
                ms.append(common.cold_ms(lambda part=part: fn.on(part)))
            step, fixed = _slope(steps, ms)
            tile = conv2.TH * src[0, 0].numel() * src.element_size()
            lines.append(dict(variant=name, probe=probe, case=case, card=gpu,
                              steps=list(steps), steps_ms=ms, ms_a_tile=step,
                              ms_fixed=fixed, tile_bytes=tile,
                              gbps=tile / step * 1e-6,
                              gbps_an_sm=tile / step * 1e-6 / sms))
    return lines


@torch.no_grad()
def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", type=json.loads, nargs="?", default={},
                        help='{"name": [[old, new] or [file, old, new], ...]}')
    parser.add_argument("--takeouts", action="store_true")
    parser.add_argument("--parent", type=str, default=None)
    parser.add_argument("--no-tree", action="store_true",
                        help="leave the tree's kernels out (--parent's only)")
    parser.add_argument("--group", nargs="*", default=list(SOURCES),
                        choices=list(SOURCES))
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--steps", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    dev = need_device("cuda")
    gpu = card()
    _, _, wsrc = conv2.seeded_operands()
    csrc32, csrc16 = dma.seeded_source()
    wsrc, csrc32, csrc16 = (t.to(dev) for t in (wsrc, csrc32, csrc16))
    lines = []
    for group in args.group:
        runs = variants(args.takeouts, args.parent, args.variants, group,
                        not args.no_tree)
        built = _native.build_variants(f"probe_ab/{group}", SOURCES[group],
                                       runs, None, None)
        libs = {name: _bind(handle, name.startswith("parent"))
                for name, (handle, _) in built.items()}
        calls = {name: _calls(group, lib, name.startswith("parent"),
                              *((wsrc,) if group == "window"
                                else (csrc32, csrc16)))
                 for name, lib in libs.items()}
        srcs = {"f32": wsrc if group == "window" else csrc32,
                "bf16": csrc16}
        keys = list(next(iter(calls.values())))
        refs = {key: _plain(key[0], srcs[key[1]]) for key in keys}
        timed = {}
        for name in libs:
            for key, fn in calls[name].items():
                if key[0] not in TAKEOUT_PROBES.get(name, key):
                    continue
                got = fn()
                torch.cuda.synchronize()
                timed[(name, key)] = dict(
                    variant=name, probe=key[0], case=key[1], card=gpu,
                    **_held(key[0], got, refs[key]), runs=[])
        order = list(timed)
        for r in range(args.rounds):
            for name, key in order if r % 2 == 0 else order[::-1]:
                timed[(name, key)]["runs"].append(
                    common.cold_ms(calls[name][key]))
        for line in timed.values():
            line["ms"] = statistics.median(line["runs"])
            lines.append(line)
        if args.steps:
            lines += _steps(group, calls, args.steps, gpu)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
