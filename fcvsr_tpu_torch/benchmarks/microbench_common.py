"""What the rows-conv probes (K9, ``microbench_conv2``) and the window-copy
probes (K10, ``microbench_dma``) share: their library and their timings.

The library is built from ``csrc/microbench/*.cu`` at first use, by
``ops._native.side_lib`` into ``_build/microbench/``, apart from the model's
library.  Two timings, both with CUDA events on the current stream, each
event pair preceded by a spin of the stream (``torch.cuda._sleep``) that
outlasts the host's enqueue of the timed launches, so that no gap of the
host's falls inside the pair:

  cold_ms  for a probe whose source fits in the 50 MB L2: before each launch
           a 128 MiB buffer is written and read back, which evicts the
           source and leaves the L2's lines clean (a write alone would leave
           up to 50 MB of dirty lines that the timed launch writes back as
           it reads); the median of ``COLD_REPS`` launches;
  warm_ms  for a probe whose operands are resident by design: ``n``
           launches (``WARM_ITERS``) between one event pair, divided by
           ``n``.
"""

from __future__ import annotations

import ctypes
import re
import statistics
from pathlib import Path

import torch

from ..ops import _native

__all__ = ["lib", "cold_ms", "warm_ms", "sass", "sass_faults", "SOURCES",
           "FLUSH_BYTES", "COLD_REPS", "WARM_ITERS", "SASS_OPS", "SASS_WANTS"]

SOURCES = sorted((Path(__file__).resolve().parent.parent / "csrc"
                  / "microbench").glob("*.cu"))
FLUSH_BYTES = 128 << 20
COLD_REPS, WARM_ITERS = 30, 50
# spins of the stream before an event pair, in clock cycles: about 0.5 ms
# before one launch and 10 ms before WARM_ITERS launches at the H100's
# clock, above what the host takes to enqueue a wrapper's launch (0.03 to
# 0.2 ms from Python)
COLD_SPIN, WARM_SPIN = 1_000_000, 20_000_000

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    # rhs, w, out, checksums, partials, counters, TH, WP, tiles, stream
    "fcvsr_mb_mm_stream": [_P] * 6 + [_I] * 3 + [_P],
    # src, out, sums, TH, C, WP, tiles, build, stream
    "fcvsr_mb_window": [_P] * 3 + [_I] * 5 + [_P],
    # src, out, folds, total bytes, WP, bf16, stream
    "fcvsr_mb_one_shot": [_P, _P, _P, _L, _I, _I, _P],
    # src, out, folds, tiles, TH, row bytes, WP, bf16, dbuf, stream
    "fcvsr_mb_slabs": [_P, _P, _P, _I, _I, _L, _I, _I, _I, _P],
}


def lib():
    """The probes' library (built on first call; a failed build raises)."""
    return _native.side_lib("microbench", SOURCES, SIGNATURES,
                            "fcvsr_mb_error_string")[0]


# SASS ops: wgmma, a TMA tensor load, a TMA bulk copy, cp.async (an
# element copy through the SM's threads), mma.sync, ldmatrix
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "LDGSTS", "HMMA", "LDSM")
# the probes' kernels, each with the ops it must hold and those it must
# not: the mm stream on wgmma fed by TMA tensor loads, the window kernel's
# six instantiations (im2col or not, 64, 32 or 16 lanes a unit) on TMA
# tensor loads, the copies on bulk copies; none copies through cp.async
SASS_WANTS = {"mm_stream_kernel": (("HGMMA", "UTMALDG"), ("HMMA", "LDSM", "LDGSTS")),
              **{f"window_kernel<{b}, {n}>": (("UTMALDG",), ("LDGSTS",))
                 for b in ("im2col", "dma_window") for n in (64, 32, 16)},
              "copy_kernel": (("UBLKCP",), ("LDGSTS",))}


def _readable(mangled: str) -> str:
    got = re.search(r"window_kernelILb([01])ELi(\d+)E", mangled)
    if got:
        return (f"window_kernel<{'im2col' if got[1] == '1' else 'dma_window'}"
                f", {got[2]}>")
    return next((k for k in ("mm_stream_kernel", "copy_kernel") if k in mangled),
                mangled)


def sass(path=None):
    """{kernel: {op: count}} of :data:`SASS_OPS` for the probes' kernels
    in ``cuobjdump -sass`` of their library (``path``, or the one
    :func:`lib` builds), under the names of :data:`SASS_WANTS`.  None when
    the toolkit has no cuobjdump."""
    counts = _native.sass_ops(path or lib()._name, "_kernel", SASS_OPS)
    return None if counts is None else {
        _readable(name): ops for name, ops in counts.items()}


def sass_faults(counts) -> list:
    """What :func:`sass` found against :data:`SASS_WANTS`: a kernel
    missing or unknown, an op missing or present that must not be."""
    faults = [f"{k}: not found" for k in SASS_WANTS if k not in counts]
    faults += [f"{k}: not a probe kernel" for k in counts if k not in SASS_WANTS]
    for k, (need, never) in SASS_WANTS.items():
        ops = counts.get(k)
        if ops is None:
            continue
        faults += [f"{k}: no {op}" for op in need if not ops[op]]
        faults += [f"{k}: {ops[op]} {op}" for op in never if ops[op]]
    return faults


def cold_ms(fn) -> float:
    """Median CUDA-event ms of ``fn`` with the L2 flushed (written and read
    back) before each launch."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    events = []
    for i in range(COLD_REPS):
        flush.fill_(float(i))
        flush.sum()
        torch.cuda._sleep(COLD_SPIN)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def warm_ms(fn, n: int = WARM_ITERS) -> float:
    """CUDA-event ms of ``fn``: ``n`` launches after two warm-ups, one
    event pair."""
    fn()
    fn()
    torch.cuda._sleep(WARM_SPIN)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n

