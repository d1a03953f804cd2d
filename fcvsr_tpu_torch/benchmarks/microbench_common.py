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
import statistics
from pathlib import Path

import torch

from ..ops import _native

__all__ = ["lib", "cold_ms", "warm_ms", "SOURCES", "FLUSH_BYTES",
           "COLD_REPS", "WARM_ITERS"]

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
    # src, out, TH, C, WP, tiles, build, stream
    "fcvsr_mb_window": [_P, _P] + [_I] * 5 + [_P],
    # src, out, folds, total bytes, WP, bf16, stream
    "fcvsr_mb_one_shot": [_P, _P, _P, _L, _I, _I, _P],
    # src, out, folds, tiles, TH, row bytes, WP, bf16, dbuf, stream
    "fcvsr_mb_slabs": [_P, _P, _P, _I, _I, _L, _I, _I, _I, _P],
}


def lib():
    """The probes' library (built on first call; a failed build raises)."""
    return _native.side_lib("microbench", SOURCES, SIGNATURES,
                            "fcvsr_mb_error_string")[0]


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

