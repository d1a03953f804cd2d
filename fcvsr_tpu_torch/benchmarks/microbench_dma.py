"""The window copy's rate on the card (K10): one bulk copy, serial slab
copies and double-buffered slab copies, in float32 and bf16.

    python -m fcvsr_tpu_torch.benchmarks.microbench_dma \\
        [--th 16 --c 64 --wp 512 --tiles 17] [--device cuda]

Counterpart of the JAX package's ``benchmarks/microbench_dma.py``: a (1,
tiles*TH + 2, C, WP) source, float32 or bf16, copied into shared memory on
three schedules (``csrc/microbench/dma.cu``, the 1-D bulk form of TMA
completing on mbarriers).  Each returns the JAX kernel's output, a (1, 1,
WP) float32 row, and the fold of what it copied: for each ``FOLD_BYTES``
segment of the copied range, the wrapping sum of its raw 32-bit words, as
int32 (:func:`fold_plain`), so that a copy that skipped a byte shows.  Both
equal the plain version's bit for bit:

  dma_one_shot  src[0, 0, 0, :], after the whole source has been copied, as
                many blocks as it takes, one bulk copy each; the source's
                folds (ceil(bytes / FOLD_BYTES),);
  dma_serial    src[0, (tiles - 1)*TH, 0, :], the last slab's first row,
                after the tiles slabs of TH + 2 rows have been copied in
                order, one copy in flight a block; each slab's folds (tiles,
                ceil(slab bytes / FOLD_BYTES));
  dma_dbuf      the same with slab t + 1's copy issued before slab t is
                waited on, in two buffers.

Each wrapper launches its kernel on a CUDA tensor (16-byte aligned rows of
a multiple of 16 bytes: the launch fails otherwise), or raises; on a CPU
tensor it runs its plain version, which makes the same copies with
``copy_`` and folds them.  ``<wrapper>.launches`` counts the launches.  The
source is drawn from seed 0 in the JAX script's order
(:func:`seeded_source`).

On a CUDA device each probe is checked against its plain version and timed
cold (the source, 35.9 MB in float32 and 18.0 MB in bf16, fits in the 50 MB
L2: a 128 MiB write, read back, before each launch, the median of 30).  One
JSON line a probe and type: the card's name and power limit, the kernel's
ms and GB/s, the least time the card could take (the source read once, the
row and the folds written, over 3.35 TB/s) and the kernel's share of it, the
plain version's ms, the library call's ms (none: no single call computes
these; the cold ``dst.copy_(src)`` of the same source stands beside them as
the copy-rate yardstick) and whether the row and the folds equal the plain
version's.  ``--device cpu`` runs the plain versions and times nothing;
without a card the default ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import _native
from ..profiling import bound, card, need_device
from . import microbench_common as common

__all__ = ["TH", "C", "WP", "TILES", "FOLD_BYTES", "seeded_source",
           "fold_plain", "dma_one_shot", "dma_serial", "dma_dbuf",
           "dma_one_shot_plain", "dma_serial_plain", "dma_dbuf_plain", "work",
           "main"]

TH, C, WP, TILES = 16, 64, 512, 17
FOLD_BYTES = 1024  # bytes a folded word (kFold in dma.cu)
REPLACES = {"dma_one_shot": "benchmarks/microbench_dma.py:60",
            "dma_serial": "benchmarks/microbench_dma.py:80",
            "dma_dbuf": "benchmarks/microbench_dma.py:102"}


def seeded_source(seed: int = 0, th: int = TH, c: int = C, wp: int = WP,
                  tiles: int = TILES):
    """(src (1, tiles*th + 2, c, wp) float32, the same rounded to bf16) on
    the CPU, uniform(-1, 1) from ``seed`` as the JAX script draws it."""
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.uniform(
        -1, 1, (1, tiles * th + 2, c, wp)).astype(np.float32))
    return src, src.to(torch.bfloat16)


def _check(src, th: int | None = None) -> int:
    """The tiles of a source (1 without ``th``); raises on a source no
    kernel takes."""
    if src.dim() != 4 or src.shape[0] != 1:
        raise ValueError(f"src must be (1, rows, C, WP), got "
                         f"{tuple(src.shape)}")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"src must be float32 or bfloat16, got {src.dtype}")
    _native.require(src, "src", src.device, dtype=src.dtype)
    rows = src.shape[1]
    if th is None:
        return 1
    tiles = (rows - 2) // th if th >= 1 else 0
    if tiles < 1 or rows != tiles * th + 2:
        raise ValueError(f"src {tuple(src.shape)}: need tiles * {th} + 2 "
                         "rows for some tiles >= 1")
    return tiles


def fold_plain(buf):
    """(ceil(bytes / FOLD_BYTES),) int32: for each FOLD_BYTES segment of a
    contiguous buffer's bytes, the sum of its little-endian 32-bit words
    modulo 2^32."""
    raw = buf.reshape(-1).view(torch.uint8)
    raw = torch.nn.functional.pad(raw, (0, -raw.numel() % FOLD_BYTES))
    sums = raw.view(torch.int32).to(torch.int64).reshape(
        -1, FOLD_BYTES // 4).sum(1) & 0xFFFFFFFF
    return (sums - ((sums >> 31) << 32)).to(torch.int32)


def dma_one_shot_plain(src):
    """The whole source copied, then (its first row's channel 0 as (1, 1,
    WP) float32, the copy's folds)."""
    _check(src)
    win = src[0].clone()
    return win[0, 0].float().reshape(1, 1, -1), fold_plain(win)


def _slabs_plain(src, th: int, buffers: int):
    tiles = _check(src, th)
    win = [torch.empty_like(src[0, :th + 2]) for _ in range(buffers)]
    folds = []
    for t in range(tiles):
        buf = win[t % buffers]
        buf.copy_(src[0, t * th:t * th + th + 2])
        folds.append(fold_plain(buf))
    return buf[0, 0].float().reshape(1, 1, -1), torch.stack(folds)


def dma_serial_plain(src, th: int = TH):
    """The slabs copied in order into one buffer, then (the last one's
    first row's channel 0 as (1, 1, WP) float32, each slab's folds)."""
    return _slabs_plain(src, th, 1)


def dma_dbuf_plain(src, th: int = TH):
    """:func:`dma_serial_plain` with two buffers in turn."""
    return _slabs_plain(src, th, 2)


def _folds(nbytes: int, device, tiles: int = 0):
    shape = (-(-nbytes // FOLD_BYTES),)
    return torch.empty((tiles,) + shape if tiles else shape,
                       dtype=torch.int32, device=device)


def dma_one_shot(src):
    """The one-shot copy kernel on a CUDA tensor, :func:`dma_one_shot_plain`
    on a CPU tensor."""
    if _native.on_cpu(src):
        return dma_one_shot_plain(src)
    _check(src)
    total = src[0].numel() * src.element_size()
    out = torch.empty(1, 1, src.shape[3], device=src.device)
    folds = _folds(total, src.device)
    lib = common.lib()
    with _native.launch_guard(src) as stream:
        rc = lib.fcvsr_mb_one_shot(src.data_ptr(), out.data_ptr(),
                                   folds.data_ptr(), total, src.shape[3],
                                   int(src.dtype == torch.bfloat16), stream)
    _native.check_side(lib, rc, "dma_one_shot")
    dma_one_shot.launches += 1
    return out, folds


def _slabs(src, th: int, dbuf: bool):
    tiles = _check(src, th)
    row = src.shape[2] * src.shape[3] * src.element_size()
    out = torch.empty(1, 1, src.shape[3], device=src.device)
    folds = _folds(row * (th + 2), src.device, tiles)
    lib = common.lib()
    with _native.launch_guard(src) as stream:
        rc = lib.fcvsr_mb_slabs(src.data_ptr(), out.data_ptr(),
                                folds.data_ptr(), tiles, th, row,
                                src.shape[3],
                                int(src.dtype == torch.bfloat16), int(dbuf),
                                stream)
    _native.check_side(lib, rc, "dma_dbuf" if dbuf else "dma_serial")
    return out, folds


def dma_serial(src, th: int = TH):
    """The serial slab-copy kernel on a CUDA tensor,
    :func:`dma_serial_plain` on a CPU tensor."""
    if _native.on_cpu(src):
        return dma_serial_plain(src, th)
    got = _slabs(src, th, False)
    dma_serial.launches += 1
    return got


def dma_dbuf(src, th: int = TH):
    """The double-buffered slab-copy kernel on a CUDA tensor,
    :func:`dma_dbuf_plain` on a CPU tensor."""
    if _native.on_cpu(src):
        return dma_dbuf_plain(src, th)
    got = _slabs(src, th, True)
    dma_dbuf.launches += 1
    return got


for _fn in (dma_one_shot, dma_serial, dma_dbuf):
    _fn.launches = 0


def work(probe: str, element_size: int, th: int = TH, c: int = C,
         wp: int = WP, tiles: int = TILES):
    """(bytes, operations) of a probe: the source read once, the float32
    row and the int32 folds written once; an add a copied 32-bit word (the
    bound counts them at the float32 rate, a few thousandths of the bytes'
    time)."""
    src = (tiles * th + 2) * c * wp * element_size
    copied = src if probe == "dma_one_shot" else \
        tiles * (th + 2) * c * wp * element_size
    folds = -(-copied // FOLD_BYTES) if probe == "dma_one_shot" else \
        tiles * -(-(th + 2) * c * wp * element_size // FOLD_BYTES)
    return src + wp * 4 + folds * 4, copied // 4


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
    shape = dict(th=args.th, c=args.c, wp=args.wp, tiles=args.tiles)
    gpu = card() if cuda else None
    reports = []
    for src in (t.to(dev) for t in seeded_source(**shape)):
        case = "bf16" if src.dtype == torch.bfloat16 else "f32"
        probes = {
            "dma_one_shot": (lambda: dma_one_shot(src),
                             lambda: dma_one_shot_plain(src)),
            "dma_serial": (lambda: dma_serial(src, args.th),
                           lambda: dma_serial_plain(src, args.th)),
            "dma_dbuf": (lambda: dma_dbuf(src, args.th),
                         lambda: dma_dbuf_plain(src, args.th)),
        }
        for name, (kern, plain) in probes.items():
            nbytes, flops = work(name, src.element_size(), **shape)
            bound_ms, bound_by = bound(nbytes, flops)
            (got, folds), (ref, ref_folds) = kern(), plain()
            row_equal = bool(torch.equal(got, ref))
            folds_equal = bool(torch.equal(folds, ref_folds))
            rep = dict(probe=name, case=case, replaces=REPLACES[name],
                       shape=shape, device=str(dev), card=gpu,
                       equal=row_equal and folds_equal, row_equal=row_equal,
                       folds_equal=folds_equal, folds=list(folds.shape),
                       folds_differing=int((folds != ref_folds).sum()),
                       max_abs_dev=float((got - ref).abs().max()),
                       bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                       ms=None, plain_ms=None,
                       library="none: no single call", library_ms=None,
                       yardstick="dst.copy_(src)", yardstick_ms=None,
                       bound_share=None)
            if cuda:
                dst = torch.empty_like(src)
                rep["ms"] = common.cold_ms(kern)
                rep["plain_ms"] = common.cold_ms(plain)
                rep["yardstick_ms"] = common.cold_ms(lambda: dst.copy_(src))
                rep["gbps"] = nbytes / rep["ms"] * 1e-6
                rep["bound_share"] = bound_ms / rep["ms"]
                rep["timing"] = (f"cold, 128 MiB written and read back and "
                                 f"a spin before each launch, median of "
                                 f"{common.COLD_REPS}")
            print(json.dumps(rep), flush=True)
            reports.append(rep)
    return {"probes": reports}


if __name__ == "__main__":
    main()
