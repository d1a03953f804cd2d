"""An A/B of the conv pair's kernel (K2, ``csrc/conv3x3.cu``), or with
``--quad`` of the BlockRCB quad's (K6, ``csrc/conv3x3_quad.cu``), against
edited copies of itself, on the card.

    python -m fcvsr_tpu_torch.benchmarks.pair_ab \\
        '{"base": [], "no_mma": [["conv_tc.cuh", "wgmma_m64k16_bf16<N, 0>(acc, da, db, tap | s | p);", ""]]}' \\
        [--shapes f32:272x480:128 bf16:272x480:128] [--reps 7]
    python -m fcvsr_tpu_torch.benchmarks.pair_ab --quad --takeouts \\
        [--shapes bf16:272x480:128]

A variant is the tree's ``conv3x3.cu`` (``conv3x3_quad.cu`` with
``--quad``) with each ``old`` text replaced by ``new``; an edit
``["conv_tc.cuh", old, new]`` (or ``hopper.cuh``) edits that header
instead: ``conv_tc.cuh`` holds K2's row loop and its helpers, which the
quad runs too.  An edit whose ``old`` text is missing raises.  A variant
given as a directory's path builds that directory's source (and its
headers, where it has them).  ``ONE_PASS`` is the edit of one bf16 product
a k step.  ``--takeouts`` (with ``--quad``) adds the tree's quad
(``base``) and :data:`QUAD_TAKEOUTS`: the grid barrier made a block's
(``no_barrier``: phase 2 may read y before it is written, so the result
misses its bar), phase 1 alone (``phase1``: y only) and phase 2 alone
(``phase2``: out from whatever y holds).  nvcc builds every variant at
once, the source alone into a library of its own under
``_build/pair_ab/<name>/`` (``_native.build_variants``), and ptxas's
registers and spills of each kernel are printed.  At each shape (storage,
H x W, C1; Cin = Cout = 64, SCNet's pairs, seeded weights at 0.03-0.04;
the quad runs the pair and then a 64->64->64 pair, as a BlockRCB body
does) every variant runs once and is held to the plain version (its max
deviation over max(1, max|plain|), the quad's by its out, beside the bar:
1e-4 for float32 maps, 1.6e-2 for bf16; a variant that takes work out to
see what it costs may miss it), then the variants are timed in turns
(``profiling.cuda_ms``, the median of ``--reps``), the quad's beside its
yardstick, 2 launches of the tree's K2 (``fused_conv.conv3x3_pair``).  One
JSON line a variant and shape.  A CUDA device is needed.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import _native, fused_conv
from ..profiling import card, cuda_ms, need_device

__all__ = ["SOURCE", "QUAD_SOURCE", "ONE_PASS", "QUAD_TAKEOUTS", "main"]

SOURCE = "conv3x3.cu"
QUAD_SOURCE = "conv3x3_quad.cu"
BARS = {"f32": 1e-4, "bf16": 1.6e-2}
# the edit that makes a variant of one bf16 product a k step (the TPU
# kernel's precision) for both storage types
ONE_PASS = ["conv_tc.cuh", "constexpr int kPasses = sizeof(T) == 4 ? 3 : 2;",
            "constexpr int kPasses = 1;"]
# the quad with a piece taken out: its grid barrier, or one of its phases
_PHASE1 = ("  pair_phase<T, N1A, false>(smem, x, w1, b1, w2, b2, y, B, H, W, C, "
           "C1, C2, ns1, rows,\n                            vec_x);")
_PHASE2 = ("  pair_phase<T, N1B, true>(smem, y, w3, b3, w4, b4, out, B, H, W, C2, "
           "C3, Cout, ns3,\n                           rows, vec_y);")
QUAD_TAKEOUTS = {
    "no_barrier": [["cg::this_grid().sync();", "__syncthreads();"]],
    "phase1": [[_PHASE2, ""]],
    "phase2": [[_PHASE1, ""]],
}


def _build(variants: dict, quad: bool) -> dict:
    """{name: the variant's entry point}, built under _build/pair_ab/<name>/
    by ``_native.build_variants``; ptxas's registers and spills of each
    kernel printed."""
    entry = "fcvsr_conv3x3_quad" if quad else "fcvsr_conv3x3_pair"
    built = _native.build_variants(
        "pair_ab", QUAD_SOURCE if quad else SOURCE, variants, entry,
        _native._SIGNATURES[entry], flags=("-Xptxas=-v",))
    for name, (_, out) in built.items():
        lines = out.splitlines()
        usage = [f"{lines[i - 1].strip()} | {line.strip()}"
                 for i, line in enumerate(lines)
                 if "Used" in line and i > 1 and ("pair" in lines[i - 2]
                                                  or "quad" in lines[i - 2])]
        print(json.dumps(dict(variant=name, ptxas=usage)), flush=True)
    return {name: fn for name, (fn, _) in built.items()}


def _case(spec: str, dev):
    """'f32:272x480:128' -> (storage, x, (w1, b1, w2, b2), (r1, r2)): the
    pair and the quad's second pair (64->64->64, no biases)."""
    storage, hw, c1 = spec.split(":")
    h, w = map(int, hw.split("x"))
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x = t(rng.standard_normal((1, h, w, 64)))
    x = x if storage == "f32" else x.bfloat16()
    pair = (t(rng.standard_normal((3, 3, 64, int(c1))) * 0.04),
            t(rng.standard_normal(int(c1)) * 0.1),
            t(rng.standard_normal((3, 3, int(c1), 64)) * 0.03),
            t(rng.standard_normal(64) * 0.1))
    second = (t(rng.standard_normal((3, 3, 64, 64)) * 0.04),
              t(rng.standard_normal((3, 3, 64, 64)) * 0.04))
    return storage, x, pair, second


def _runner(lib, x, pair, second, quad: bool):
    b, h, w, cin = x.shape
    w1, b1, w2, b2 = pair
    c1, cout = w1.shape[3], w2.shape[3]
    bf16 = int(x.dtype == torch.bfloat16)

    def run():
        out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
        with _native.launch_guard(x) as stream:
            if quad:
                y = torch.empty_like(out)
                rc = lib(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                         w2.data_ptr(), b2.data_ptr(), second[0].data_ptr(),
                         None, second[1].data_ptr(), None, y.data_ptr(),
                         out.data_ptr(), b, h, w, cin, c1, cout, 64, cout,
                         0.1, 0.2, bf16, stream)
            else:
                rc = lib(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                         w2.data_ptr(), b2.data_ptr(), out.data_ptr(), b, h,
                         w, cin, c1, cout, 0.1, bf16, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out
    return run


@torch.no_grad()
def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="?", default="{}",
                    help="JSON {name: [[old, new], ...] or a directory}")
    ap.add_argument("--quad", action="store_true",
                    help="the quad's kernel (K6) instead of the pair's")
    ap.add_argument("--takeouts", action="store_true",
                    help="with --quad: base and QUAD_TAKEOUTS")
    ap.add_argument("--shapes", nargs="+", default=["f32:272x480:128"])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    variants = {"base": [], **QUAD_TAKEOUTS} if args.quad and args.takeouts \
        else {}
    variants.update(json.loads(args.variants))
    if not variants:
        raise SystemExit("pair_ab: no variant (give JSON, or --quad "
                         "--takeouts)")
    dev = need_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    libs = _build(variants, args.quad)
    lines, name_card = [], card()
    for spec in args.shapes:
        storage, x, pair, second = _case(spec, dev)
        plain = fused_conv.conv3x3_pair_plain(x, *pair, 0.1)
        if args.quad:
            plain = fused_conv.conv3x3_pair_plain(plain, second[0], None,
                                                  second[1], None, 0.2)
        plain = plain.float()
        scale = max(1.0, float(plain.abs().max()))
        runs = {name: _runner(lib, x, pair, second, args.quad)
                for name, lib in libs.items()}
        devs = {name: float((run().float() - plain).abs().max()) / scale
                for name, run in runs.items()}
        if args.quad:  # the yardstick, timed in turns with the variants
            runs["2 K2 launches"] = lambda: fused_conv.conv3x3_pair(
                fused_conv.conv3x3_pair(x, *pair, 0.1), second[0], None,
                second[1], None, 0.2)
            devs["2 K2 launches"] = float(
                (runs["2 K2 launches"]().float() - plain).abs().max()) / scale
        times = cuda_ms(list(runs.values()), args.reps)
        for (name, dv), ms in zip(devs.items(), times):
            line = dict(variant=name, shape=spec, ms=ms, rel_dev=dv,
                        bar=BARS[storage], held=dv <= BARS[storage],
                        card=name_card)
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
