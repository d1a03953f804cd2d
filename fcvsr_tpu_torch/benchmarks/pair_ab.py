"""An A/B of the conv pair's kernel (K2, ``csrc/conv3x3.cu``) against
edited copies of itself, on the card.

    python -m fcvsr_tpu_torch.benchmarks.pair_ab \\
        '{"base": [], "no_mma": [["wgmma_m64k16_bf16<N, 0>(acc, da, db, tap | s | p);", ""]]}' \\
        [--shapes f32:272x480:128 bf16:272x480:128] [--reps 7]

A variant is the tree's ``conv3x3.cu`` with each ``old`` text replaced by
``new``; an edit ``["hopper.cuh", old, new]`` (or ``conv3x3.cuh``) edits
that header instead.  An edit whose ``old`` text is missing raises.  A
variant given as a directory's path builds that directory's
``conv3x3.cu`` (and its headers, where it has them).  ``ONE_PASS`` is the
edit of one bf16 product a k step.  nvcc builds every variant at once,
``conv3x3.cu`` alone into a library of its own under
``_build/pair_ab/<name>/`` (``_native.build_variants``), and ptxas's
registers and spills of each pair kernel are printed.  At each shape
(storage, H x W, C1; Cin = Cout = 64, SCNet's pairs, seeded weights at
0.03-0.04) every variant runs once and is held to the plain version (its max
deviation over max(1, max|plain|), beside the bar: 1e-4 for float32 maps,
1.6e-2 for bf16; a variant that takes work out to see what it costs may
miss it), then the variants are timed in turns (``profiling.cuda_ms``,
the median of ``--reps``).  One JSON line a variant and shape.  A CUDA
device is needed.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import _native, fused_conv
from ..profiling import card, cuda_ms, need_device

__all__ = ["SOURCE", "ONE_PASS", "main"]

SOURCE = "conv3x3.cu"
BARS = {"f32": 1e-4, "bf16": 1.6e-2}
# the edit that makes a variant of one bf16 product a k step (the TPU
# kernel's precision) for both storage types
ONE_PASS = ["constexpr int kPasses = sizeof(T) == 4 ? 3 : 2;",
            "constexpr int kPasses = 1;"]


def _build(variants: dict) -> dict:
    """{name: the variant's fcvsr_conv3x3_pair}, built under
    _build/pair_ab/<name>/ by ``_native.build_variants``; ptxas's registers
    and spills of each pair kernel printed."""
    built = _native.build_variants(
        "pair_ab", SOURCE, variants, "fcvsr_conv3x3_pair",
        _native._SIGNATURES["fcvsr_conv3x3_pair"], flags=("-Xptxas=-v",))
    for name, (_, out) in built.items():
        lines = out.splitlines()
        usage = [f"{lines[i - 1].strip()} | {line.strip()}"
                 for i, line in enumerate(lines)
                 if "Used" in line and i > 1 and "pair" in lines[i - 2]]
        print(json.dumps(dict(variant=name, ptxas=usage)), flush=True)
    return {name: fn for name, (fn, _) in built.items()}


def _case(spec: str, dev):
    """'f32:272x480:128' -> (storage, x, w1, b1, w2, b2)."""
    storage, hw, c1 = spec.split(":")
    h, w = map(int, hw.split("x"))
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x = t(rng.standard_normal((1, h, w, 64)))
    x = x if storage == "f32" else x.bfloat16()
    return (storage, x, t(rng.standard_normal((3, 3, 64, int(c1))) * 0.04),
            t(rng.standard_normal(int(c1)) * 0.1),
            t(rng.standard_normal((3, 3, int(c1), 64)) * 0.03),
            t(rng.standard_normal(64) * 0.1))


def _runner(lib, x, w1, b1, w2, b2):
    b, h, w, cin = x.shape
    c1, cout = w1.shape[3], w2.shape[3]
    bf16 = int(x.dtype == torch.bfloat16)

    def run():
        out = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
        with _native.launch_guard(x) as stream:
            rc = lib(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                     w2.data_ptr(), b2.data_ptr(), out.data_ptr(), b, h, w,
                     cin, c1, cout, 0.1, bf16, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out
    return run


@torch.no_grad()
def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", help="JSON {name: [[old, new], ...]}")
    ap.add_argument("--shapes", nargs="+", default=["f32:272x480:128"])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    dev = need_device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    libs = _build(json.loads(args.variants))
    lines, name_card = [], card()
    for spec in args.shapes:
        storage, x, w1, b1, w2, b2 = _case(spec, dev)
        plain = fused_conv.conv3x3_pair_plain(x, w1, b1, w2, b2, 0.1).float()
        scale = max(1.0, float(plain.abs().max()))
        runs = {name: _runner(lib, x, w1, b1, w2, b2)
                for name, lib in libs.items()}
        devs = {name: float((run().float() - plain).abs().max()) / scale
                for name, run in runs.items()}
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
