"""An A/B of the IAC iteration's kernel (K1, ``csrc/iac.cu``), or with
``--chain`` of the resident chain's (K4, ``csrc/iac_chain.cu``), against
edited copies of itself, on the card: K1 taken apart, K4's choices.

    python -m fcvsr_tpu_torch.benchmarks.iac_ab [--takeouts] \\
        [--parent DIR] ['{"name": [[old, new], ...]}'] \\
        [--shapes mat:f32:1 kf:bf16:2] [--hw 272x480] [--reps 7]
    python -m fcvsr_tpu_torch.benchmarks.iac_ab --chain --takeouts \\
        [--shapes chain:f32:1 chain:bf16:2]

A variant is the tree's ``iac.cu`` with each ``old`` text replaced by
``new`` (an edit ``["iac.cuh", old, new]`` edits that header, K1's tile
body), or a directory's path, whose ``iac.cu`` and headers are built
instead, or ``{"dir": DIR, "edits": [...]}``, that directory's files
edited.  ``--takeouts`` adds the tree's kernel (``base``) and the three
edits that take a piece out (:data:`TAKEOUTS`): the gather's loads
(``no_gather``), the kernel stream or the prediction (``no_stream``: no
materialised kernel loads, no mma), the passes' shared-memory reads and
shuffles (``no_passes``).  ``--parent DIR`` adds the kernel of another
checkout's ``csrc/`` (K1's only: K4's entry point took other arguments
before).  An edit whose ``old`` text is missing raises.  nvcc builds
every variant at once, ``iac.cu`` alone into a library of its own under
``_build/iac_ab/<name>/`` (``_native.build_variants``), and ptxas's
registers and spills of each kernel are printed.

A shape is mode:storage:B (``mat`` materialised kernels or ``kf`` fused
prediction; ``f32`` or ``bf16`` maps) at ``--hw`` x 64 channels, C0 64,
seeded inputs as chip_smoke.py draws them.  Each variant runs once and is
held to the plain version (its max deviation over max(1, max|plain|),
beside the bar: 2e-5 for float32 maps, 1.6e-2 for bf16; a takeout misses
it), then the variants are timed in turns (``profiling.cuda_ms``, the
median of ``--reps``).  One JSON line a variant and shape.  A CUDA device
is needed.

``--chain`` builds variants of ``iac_chain.cu`` instead (its shapes
``chain:storage:B``, 6 iterations of materialised kernels, a flow each);
``--takeouts`` then adds the tree's chain (``base``) and
:data:`CHAIN_VARIANTS`: the gather through L2 only (``l2``), two blocks an
SM (``two_blocks``).  Each variant is held bit for bit to the tree's K1
launched once an iteration (``fused_iac.iac_fused``), at the shape and at
two small odd ones, where the maps fit an SM's L1 and a stale line would
show (``equal_small``), then timed in turns beside those 6 K1 launches.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import _native, fused_iac
from ..profiling import card, cuda_ms, need_device

__all__ = ["SOURCE", "CHAIN_SOURCE", "TAKEOUTS", "CHAIN_VARIANTS",
           "variants", "main"]

SOURCE = "iac.cu"
CHAIN_SOURCE = "iac_chain.cu"
BARS = {"f32": 2e-5, "bf16": 1.6e-2}
# the tree's kernel with a piece taken out: edits of its tile body,
# iac.cuh (which K4 runs too)
TAKEOUTS = {
    "no_gather": [
        ["iac.cuh",
         "load8<SRC>(a[i], featb + (size_t)c.off[i] * C + grp * 8, C - grp * 8, vec);",
         "for (int j = 0; j < 8; ++j) a[i][j] = c.wt[i];"]],
    "no_stream": [
        ["iac.cuh",
         "for (int t = 0; t < 3; ++t) kr[t][h] = load2(kp + t * C, min(2, C - ch), pairs);",
         "for (int t = 0; t < 3; ++t) kr[t][h] = load2(kp, 0, pairs);"],
        ["iac.cuh",
         "            mma<T>(acc[t], ah, bh[t][s]);\n"
         "            mma<T>(acc[t], ah, bl[t][s]);\n"
         "            if constexpr (sizeof(T) == 4) mma<T>(acc[t], al, bh[t][s]);",
         "            acc[t][0] += __uint_as_float(ah[0]);"]],
    "no_passes": [
        ["iac.cuh",
         "const float2 wv = *reinterpret_cast<const float2*>(wp + t * MP * CP);",
         "const float2 wv = make_float2(1.f, 1.f);"],
        ["iac.cuh",
         "        const float nx0 = __shfl_sync(0xffffffffu, v[0][e], (lane + 4) & 31);\n"
         "        const float nx1 = __shfl_sync(0xffffffffu, v[1][e], (lane + 4) & 31);\n"
         "        const float pv0 = __shfl_sync(0xffffffffu, v[0][e], (lane + 28) & 31);\n"
         "        const float pv1 = __shfl_sync(0xffffffffu, v[1][e], (lane + 28) & 31);",
         "        const float nx0 = v[0][e], nx1 = v[1][e], pv0 = v[0][e], pv1 = v[1][e];"]],
}


# the resident chain's alternatives: how its gather reads the map the
# iteration before wrote, and its blocks an SM
CHAIN_VARIANTS = {
    "l2": [["constexpr int kChainSrc = kSrcL1;",
            "constexpr int kChainSrc = kSrcL2;"]],
    "two_blocks": [["__launch_bounds__(kThreads, 3)\niac_chain_kernel(",
                    "__launch_bounds__(kThreads, 2)\niac_chain_kernel("]],
}


def variants(takeouts: bool, parent: str | None, extra: dict,
             chain: bool = False) -> dict:
    """{name: edits} of the runs asked for (see the module's note)."""
    out = {}
    if takeouts:
        out["base"] = []
        out.update(CHAIN_VARIANTS if chain else TAKEOUTS)
    if parent:
        out["parent"] = parent
    out.update(extra)
    return out


def _build(runs: dict, chain: bool = False) -> dict:
    """{name: (the variant's entry point, whether it takes Wsel's bf16
    planes)}; ptxas's registers and spills of each kernel printed."""
    source, entry = (CHAIN_SOURCE, "fcvsr_iac_chain") if chain \
        else (SOURCE, "fcvsr_iac_step")
    built = _native.build_variants(
        "iac_ab", source, runs, entry, _native._SIGNATURES[entry],
        flags=("-Xptxas=-v",))
    libs = {}
    for name, (fn, out) in built.items():
        lines = out.splitlines()
        usage = [f"{lines[i - 1].strip()} | {line.strip()}"
                 for i, line in enumerate(lines)
                 if "Used" in line and i > 1 and "_kernel" in lines[i - 2]]
        print(json.dumps(dict(variant=name, ptxas=usage)), flush=True)
        text = _native.edited_sources(source, runs[name])[source]
        libs[name] = (fn, "wpl" in text)
    return libs


def _case(spec: str, h: int, w: int, dev, c: int = 64):
    """'kf:bf16:2' -> (mode, storage, inputs) at h x w x c, C0 64; the
    chain's 6 flows as ``offs``."""
    mode, storage, b = spec.split(":")
    b, n_it = int(b), 6
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    st = torch.float32 if storage == "f32" else torch.bfloat16
    flow = rng.standard_normal((b, h, w, 2)) * 1.5
    flow[:, : h // 3] = rng.uniform(-20, 20, (b, h // 3, w, 2))
    ins = dict(feat=t(rng.standard_normal((b, h, w, c))).to(st),
               fin=t(rng.standard_normal((b, h, w, c))).to(st), flow=t(flow),
               k=t(rng.standard_normal((b, h, w, n_it * 3 * c)) * 0.3).to(st),
               f0=t(rng.standard_normal((b, h, w, c))).to(st),
               wsel=t(rng.standard_normal((c, n_it * 3 * c)) * 0.1),
               bsel=t(rng.standard_normal(n_it * 3 * c) * 0.1))
    if mode == "chain":
        offs = rng.standard_normal((n_it, b, h, w, 2)) * 1.5
        offs[:, :, : h // 3] = rng.uniform(-20, 20, (n_it, b, h // 3, w, 2))
        ins["offs"] = t(offs)
    return mode, storage, ins


def _plain(mode, ins):
    c = ins["feat"].shape[-1]
    if mode == "chain":  # the yardstick, K1 once an iteration
        return fused_iac.iac_fused(ins["fin"], ins["k"], ins["offs"], 6, c)
    k = ins["k"] if mode == "mat" else fused_iac.predict_kernels(
        ins["f0"], ins["wsel"], ins["bsel"], 0, c)
    return fused_iac.warp_sac_plain(ins["feat"], ins["flow"], k, ins["fin"])


def _chain_runner(fn, ins):
    fin, k, offs = ins["fin"], ins["k"], ins["offs"]
    b, h, w, c = fin.shape

    def run():
        out = torch.empty_like(fin)
        scratch, counters = fused_iac.chain_scratch(fin, offs.shape[0])
        with _native.launch_guard(fin) as stream:
            rc = fn(fin.data_ptr(), offs.data_ptr(), k.data_ptr(),
                    scratch.data_ptr(), out.data_ptr(), counters.data_ptr(),
                    b, h, w, c, offs.shape[0], 1, _native.storage(fin),
                    stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out
    return run


def _runner(fn, planes_abi: bool, mode, ins):
    if mode == "chain":
        return _chain_runner(fn, ins)
    feat, fin = ins["feat"], ins["fin"]
    b, h, w, c = feat.shape
    kf = mode == "kf"
    k = (fused_iac.wsel_planes(ins["wsel"], feat.dtype == torch.float32)
         if planes_abi else ins["wsel"]) if kf else ins["k"]
    f0, bsel = (ins["f0"], ins["bsel"]) if kf else (None, None)

    def run():
        out = torch.empty_like(feat)
        with _native.launch_guard(feat) as stream:
            rc = fn(feat.data_ptr(), ins["flow"].data_ptr(), k.data_ptr(),
                    k.shape[-1] if not kf else ins["wsel"].shape[-1], 0,
                    _native.ptr(f0), _native.ptr(bsel),
                    f0.shape[-1] if kf else 0, fin.data_ptr(), out.data_ptr(),
                    b, h, w, c, 1, _native.storage(feat), stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out
    return run


@torch.no_grad()
def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="?", default="{}",
                    help="JSON {name: [[old, new], ...] or a directory}")
    ap.add_argument("--takeouts", action="store_true")
    ap.add_argument("--chain", action="store_true",
                    help="the resident chain's kernel (K4) instead of K1's")
    ap.add_argument("--parent", help="another checkout's csrc/ directory")
    ap.add_argument("--shapes", nargs="+",
                    default=["mat:f32:1", "kf:f32:1", "kf:bf16:2"])
    ap.add_argument("--hw", default="272x480")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if args.chain and args.parent:
        raise SystemExit("iac_ab: --parent times K1 only")
    runs = variants(args.takeouts, args.parent, json.loads(args.variants),
                    args.chain)
    if not runs:
        raise SystemExit("iac_ab: no variant (give JSON, --takeouts or "
                         "--parent)")
    dev = need_device("cuda")
    libs = _build(runs, args.chain)
    h, w = map(int, args.hw.split("x"))
    lines, name_card = [], card()
    for spec in args.shapes:
        mode, storage, ins = _case(spec, h, w, dev)
        plain = _plain(mode, ins).float()
        scale = max(1.0, float(plain.abs().max()))
        fns = {name: _runner(fn, abi, mode, ins)
               for name, (fn, abi) in libs.items()}
        devs = {name: float((run().float() - plain).abs().max()) / scale
                for name, run in fns.items()}
        bar = 0.0 if mode == "chain" else BARS[storage]
        small = {}
        if mode == "chain":  # bit for bit where the maps fit L1 too
            cases = [_case(f"chain:{storage}:2", 13, 29, dev, 20),
                     _case(f"chain:{storage}:1", 5, 7, dev, 64)]
            small = {name: all(torch.equal(_runner(fn, abi, "chain", c[2])(),
                                           _plain("chain", c[2]))
                               for c in cases)
                     for name, (fn, abi) in libs.items()}
            fns["6 K1 launches"] = lambda: _plain("chain", ins)
            devs["6 K1 launches"] = 0.0
        times = cuda_ms(list(fns.values()), args.reps)
        for (name, dv), ms in zip(devs.items(), times):
            line = dict(variant=name, shape=spec, hw=args.hw, ms=ms,
                        rel_dev=dv, bar=bar, held=dv <= bar,
                        card=name_card)
            if name in small:
                line["equal_small"] = small[name]
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
