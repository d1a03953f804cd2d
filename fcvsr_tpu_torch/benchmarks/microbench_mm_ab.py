"""An A/B of the mm probes' kernel (K9, ``csrc/microbench/conv2.cu``)
against edited copies of itself, on the card.

    python -m fcvsr_tpu_torch.benchmarks.microbench_mm_ab \\
        '{"base": [], "s2": [["kStages = 4;", "kStages = 2;"]]}' \\
        [--tiles 16 33]

A variant is the tree's ``conv2.cu`` with each ``old`` text replaced by
``new``; an edit ``["hopper.cuh", old, new]`` edits ``csrc/hopper.cuh``
instead.  An edit whose ``old`` text is missing raises.  nvcc builds every
variant at once into a library of its own under ``_build/mm_ab/<name>/``
(``_native.build_variants``).
Each is held to the plain version at the probes' real shape (the max
deviation over max|plain|, and whether every tile's checksum is the same),
then timed warm (``microbench_common.warm_ms``) in 4 rounds, the variants
in turns, forwards and backwards by round, beside ``torch.bmm`` of the
same operands.  One JSON line a variant: the median ms, every round's ms,
the TFLOP/s and the L2 rate (every tile's rhs and w once a block).
``--tiles`` also times the first variant and ``torch.bmm`` at other tile
counts, to tell time that follows the rounds of work from time that
follows the bytes.  A CUDA device is needed.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..ops import _native
from ..profiling import card, need_device
from . import microbench_common as common
from . import microbench_conv2 as conv2

__all__ = ["SOURCE", "main"]

ROUNDS = 4
SOURCE = "microbench/conv2.cu"


def _build(variants: dict) -> dict:
    """{name: the variant's fcvsr_mb_mm_stream}, built under
    _build/mm_ab/<name>/ by ``_native.build_variants``."""
    built = _native.build_variants(
        "mm_ab", SOURCE, variants, "fcvsr_mb_mm_stream",
        common.SIGNATURES["fcvsr_mb_mm_stream"])
    return {name: fn for name, (fn, _) in built.items()}


def _runner(fn, rhs, w, tiles: int):
    th, _, wp = rhs.shape

    def run():
        out = torch.empty(th, conv2.MM_C, wp, device=rhs.device)
        sums = torch.empty(tiles, device=rhs.device)
        partials = torch.empty(tiles * th * -(-wp // conv2.MM_LANES) * 2,
                               device=rhs.device)
        counters = torch.zeros(tiles, dtype=torch.int32, device=rhs.device)
        rc = fn(rhs.data_ptr(), w.data_ptr(), out.data_ptr(), sums.data_ptr(),
                partials.data_ptr(), counters.data_ptr(), th, wp, tiles,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mm_stream variant launch failed: CUDA "
                               f"error {rc}")
        return out, sums
    return run


def _bmm(rhs, w, tiles: int):
    th, k, wp = rhs.shape
    x = rhs.permute(1, 0, 2).reshape(k, th * wp)
    wb = w.to(torch.bfloat16)
    return lambda: torch.bmm(wb.expand(tiles, *wb.shape),
                             x.expand(tiles, k, th * wp),
                             out_dtype=torch.float32)


@torch.no_grad()
def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", type=json.loads,
                        help='{"name": [[old, new] or [file, old, new], ...]}')
    parser.add_argument("--tiles", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    dev = need_device("cuda")
    rhs, w, _ = (t.to(dev) for t in conv2.seeded_operands())
    tiles = conv2.TILES
    flops = conv2.work("mm_stream")[1]
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    l2 = sum(conv2.mm_l2_bytes(blocks=blocks))
    libs = _build(args.variants)
    ref, ref_sums = conv2.mm_stream_plain(rhs, w, tiles)
    gpu = card()
    lines = []
    for name, fn in libs.items():
        out, sums = _runner(fn, rhs, w, tiles)()
        torch.cuda.synchronize()
        lines.append(dict(
            variant=name, card=gpu,
            rel_dev=float((out - ref).abs().max() / ref.abs().max()),
            checksums_equal=len(set(sums.tolist())) == 1,
            checksum=float(sums[0]), checksum_plain=float(ref_sums[0])))
    runs = {name: [] for name in [*libs, "torch.bmm"]}
    order = list(libs)
    for r in range(ROUNDS):
        for name in order if r % 2 == 0 else order[::-1]:
            runs[name].append(common.warm_ms(_runner(libs[name], rhs, w,
                                                     tiles)))
        runs["torch.bmm"].append(common.warm_ms(_bmm(rhs, w, tiles)))
    lines.append(dict(variant="torch.bmm", card=gpu))
    for line in lines:
        ms = statistics.median(runs[line["variant"]])
        line.update(ms=ms, runs=runs[line["variant"]],
                    tflops=flops / ms * 1e-9, l2_tbps=l2 / ms * 1e-9)
    first = next(iter(libs))
    for t in args.tiles:
        ms = common.warm_ms(_runner(libs[first], rhs, w, t))
        bmm_ms = common.warm_ms(_bmm(rhs, w, t))
        units = t * rhs.shape[0] * -(-rhs.shape[2] // conv2.MM_LANES)
        lines.append(dict(variant=first, tiles=t, items=units,
                          rounds=-(-units // blocks), ms=ms,
                          ms_per_tile=ms / t, bmm_ms=bmm_ms,
                          bmm_ms_per_tile=bmm_ms / t))
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
