"""An A/B of the IAC iteration's kernel (K1, ``csrc/iac.cu``), or with
``--chain`` of the resident chain's (K4, ``csrc/iac_chain.cu``), against
edited copies of itself, on the card: K1 taken apart, K4's choices.

    python -m fcvsr_tpu_torch.benchmarks.iac_ab [--takeouts] \\
        [--parent DIR] ['{"name": [[old, new], ...]}'] \\
        [--shapes mat:f32:1 kf:bf16:2] [--hw 272x480] [--reps 7]
    python -m fcvsr_tpu_torch.benchmarks.iac_ab --chain --takeouts \\
        [--shapes chain:f32:1 chain:bf16:2]
    python -m fcvsr_tpu_torch.benchmarks.iac_ab --bwd --takeouts \\
        [--parent DIR] [--its 0 5] [--b 6] [--hw 128x128]

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

``--bwd`` builds variants of the IAC adjoint's kernel (K5,
``iac_bwd.cu``) instead, at FCVSR's training shape (``--b`` 6 x ``--hw``
128x128 x 64, 6 iterations of kernels, flows mixed as chip_smoke.py draws
them), one case an iteration of ``--its`` (the cotangent masked by the
activation at it 0, as the chain's walk gives it, not at the others).
``--takeouts`` adds the tree's kernel (``base``) and :data:`BWD_TAKEOUTS`;
with ``--parent DIR`` it also adds that checkout's kernel with each of
:data:`PARENT_BWD_TAKEOUTS` (the two-launch kernel of before the redesign:
``parent_<name>``).  A variant is called as its own wrapper called it:
the one-launch entry point through ``fused_iac.launch_adjoint``, the
two-launch pair (``fcvsr_iac_bwd_sac``, then ``fcvsr_iac_bwd_warp``) into
a ``dwarped`` map; dk is one buffer, as the chain passes it.  Each variant
runs once and is held to ``fused_iac.warp_sac_vjp_plain`` (each gradient's
max deviation over max(1, its max|plain|), beside the bar 1e-5; a takeout
misses it), then the variants are timed in turns.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..ops import _native, fused_iac
from .dcn_ab import _checked, mixed_offsets
from ..profiling import card, cuda_ms, need_device

__all__ = ["SOURCE", "CHAIN_SOURCE", "BWD_SOURCE", "TAKEOUTS",
           "CHAIN_VARIANTS", "BWD_TAKEOUTS", "PARENT_BWD_TAKEOUTS",
           "variants", "main"]

SOURCE = "iac.cu"
CHAIN_SOURCE = "iac_chain.cu"
BWD_SOURCE = "iac_bwd.cu"
BARS = {"f32": 2e-5, "bf16": 1.6e-2}
BWD_BAR = 1e-5
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


# K5's takeouts: the tree's kernel with a piece taken out: dsrc's float4
# atomics as plain stores, the warp's adjoint (dsrc's scatter and dflow),
# the gather's corner loads, the dk stores, dflow's atomics as plain
# stores, the kernels' loads, gz's loads, the v and dv passes
BWD_TAKEOUTS = {
    "no_atomics": [[
        "if (pt.px[m] >= 0) add4(dsrc + (size_t)pt.px[m] * C + c, weight(pt, m) * dw, n, vec);",
        "if (pt.px[m] >= 0) store4(dsrc + (size_t)pt.px[m] * C + c, weight(pt, m) * dw, n, "
        "vec);"]],
    "no_warp_adjoint": [
        ["if (pt.px[m] >= 0) add4(dsrc + (size_t)pt.px[m] * C + c, weight(pt, m) * dw, n, vec);",
         "if (pt.px[m] == -2) add4(dsrc + (size_t)pt.px[m] * C + c, weight(pt, m) * dw, n, "
         "vec);"],
        ["    if (q == 0 && y < H && x < W) {",
         "    if (q == 0 && y < H && x < W && ax == 12345.f) {"]],
    "no_corners": [[
        "s[i] = pt.px[i] >= 0 ? load4(src + (size_t)pt.px[i] * C + c, n, vec)",
        "s[i] = pt.px[i] >= 0 ? make_float4(pt.fx, pt.fy, 1.f, 2.f)"]],
    "no_dk": [["        store4(dkp + t * C,", "        if (W < 0) store4(dkp + t * C,"]],
    "no_dflow_atomics": [["        atomicAdd(df, ax);\n        atomicAdd(df + 1, ay);",
                          "        df[0] = ax;\n        df[1] = ay;"]],
    "no_kernel_loads": [[
        "for (int t = 0; t < 3; ++t) ks[t * NQ] = load4(kp + t * C, n, vec);",
        "for (int t = 0; t < 3; ++t) ks[t * NQ] = make_float4(pt.fx, pt.fy, (float)t, 1.f);"]],
    "no_gz_loads": [[
        "const float4 gv = y == yy && x == xx ? load4(gz + (size_t)pix * C + c, n, vec)",
        "const float4 gv = y == yy && x == xx ? make_float4(pt.fx, 1.f, 2.f, 3.f)"]],
    "no_passes": [
        ["for (int e = tid; e < TH * HC * NQ; e += kThreads) {",
         "for (int e = tid; e < TH * HC * NQ * (W < 0); e += kThreads) {"],
        ["for (int e = tid; e < HR * TW * NQ; e += kThreads) {",
         "for (int e = tid; e < HR * TW * NQ * (W < 0); e += kThreads) {"]],
}
# the two-launch kernel of before the redesign (its launch 1, the SAC
# adjoint into dwarped; its launch 2, the warp adjoint, one warp a pixel):
# launch 2's atomics as plain stores, launch 2 altogether, launch 1's
# corner loads, the dk stores
PARENT_BWD_TAKEOUTS = {
    "no_atomics": [[
        "    if (ok00) atomicAdd(dsrc + o00 + c, g * w00);\n"
        "    if (ok01) atomicAdd(dsrc + o01 + c, g * w01);\n"
        "    if (ok10) atomicAdd(dsrc + o10 + c, g * w10);\n"
        "    if (ok11) atomicAdd(dsrc + o11 + c, g * w11);",
        "    if (ok00) dsrc[o00 + c] = g * w00;\n"
        "    if (ok01) dsrc[o01 + c] = g * w01;\n"
        "    if (ok10) dsrc[o10 + c] = g * w10;\n"
        "    if (ok11) dsrc[o11 + c] = g * w11;"]],
    "no_launch2": [[
        "  warp_adjoint_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(",
        "  if (npix < 0) warp_adjoint_kernel<<<blocks, kThreads, 0, "
        "(cudaStream_t)stream>>>("]],
    "no_corners": [[
        "return in_frame(yi, xi, H, W) ? s[((size_t)yi * W + xi) * C] : 0.f;",
        "return in_frame(yi, xi, H, W) ? 1.f : 0.f;"]],
    "no_dk": [[
        "      dkp[t * C] = g * v_s[(r * HC + j + t) * CC + ch] +",
        "      if (g == 12345.f) dkp[t * C] = g * v_s[(r * HC + j + t) * CC + ch] +"]],
}


def variants(takeouts: bool, parent: str | None, extra: dict,
             chain: bool = False, bwd: bool = False) -> dict:
    """{name: edits} of the runs asked for (see the module's note)."""
    out = {}
    if takeouts:
        out["base"] = []
        out.update(CHAIN_VARIANTS if chain else BWD_TAKEOUTS if bwd
                   else TAKEOUTS)
    if parent:
        out["parent"] = parent
        if takeouts and bwd:
            out.update({f"parent_{name}": {"dir": parent, "edits": edits}
                        for name, edits in PARENT_BWD_TAKEOUTS.items()})
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
        _ptxas(name, out)
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


def _ptxas(name: str, out: str) -> None:
    lines = out.splitlines()
    usage = [f"{lines[i - 1].strip()} | {line.strip()}"
             for i, line in enumerate(lines)
             if "Used" in line and i > 1 and "_kernel" in lines[i - 2]]
    print(json.dumps(dict(variant=name, ptxas=usage)), flush=True)


_P, _I = ctypes.c_void_p, ctypes.c_int
# the entry points of K5's two-launch version (before the redesign)
_TWO_LAUNCH = {
    # src, flow, k, k_ld, k_off, gz, dk, dwarped, B, H, W, C, stream
    "fcvsr_iac_bwd_sac": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    # src, flow, dwarped, dsrc, dflow, B, H, W, C, stream
    "fcvsr_iac_bwd_warp": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _bind_bwd(handle, name: str):
    """A callable (src, flow, k, gz, it, dk) -> (dsrc, dflow, dk) of a K5
    variant, called as its own wrapper called it."""
    if hasattr(handle, "fcvsr_iac_bwd"):
        fn = handle.fcvsr_iac_bwd
        fn.argtypes, fn.restype = _native._SIGNATURES["fcvsr_iac_bwd"], _I
        fn = _checked(fn, name)
        return lambda *a: fused_iac.launch_adjoint(fn, *a)
    two = {}
    for entry, argtypes in _TWO_LAUNCH.items():
        fn = getattr(handle, entry)
        fn.argtypes, fn.restype = argtypes, _I
        two[entry] = _checked(fn, name)

    def call(src, flow, k, gz, it, dk):
        b, h, w, c = src.shape
        dwarped = torch.empty_like(src)
        dsrc = torch.zeros_like(src)
        dflow = torch.empty_like(flow)
        with _native.launch_guard(src) as stream:
            two["fcvsr_iac_bwd_sac"](
                src.data_ptr(), flow.data_ptr(), k.data_ptr(), k.shape[-1],
                it * 3 * c, gz.data_ptr(), dk.data_ptr(), dwarped.data_ptr(),
                b, h, w, c, stream)
            two["fcvsr_iac_bwd_warp"](
                src.data_ptr(), flow.data_ptr(), dwarped.data_ptr(),
                dsrc.data_ptr(), dflow.data_ptr(), b, h, w, c, stream)
        return dsrc, dflow, dk
    return call


def _bwd_case(b: int, h: int, w: int, dev, c: int = 64, n_it: int = 6):
    """K5's inputs at the training shape: src, flows as chip_smoke.py mixes
    them, n_it iterations of kernels, a cotangent."""
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return dict(src=t(rng.standard_normal((b, h, w, c))),
                flow=t(mixed_offsets(rng, b, h, w, 2)),
                k=t(rng.standard_normal((b, h, w, n_it * 3 * c)) * 0.3),
                g=t(rng.standard_normal((b, h, w, c))))


def _main_bwd(args, runs) -> list:
    dev = need_device("cuda")
    built = _native.build_variants("iac_ab_bwd", BWD_SOURCE, runs, None,
                                   None, flags=("-Xptxas=-v",))
    fns = {}
    for name, (handle, out) in built.items():
        _ptxas(name, out)
        fns[name] = _bind_bwd(handle, name)
    h, w = map(int, (args.hw or "128x128").split("x"))
    ins = _bwd_case(args.b, h, w, dev)
    src, flow, k, g = ins["src"], ins["flow"], ins["k"], ins["g"]
    lines, name_card = [], card()
    for it in args.its:
        gz = torch.where(src > 0, g, 0.1 * g) if it == 0 else g
        dk = torch.zeros_like(k)
        ref = fused_iac.warp_sac_vjp_plain(src, flow, k, gz, it)
        devs = {}
        for name, fn in fns.items():
            dk.zero_()
            got = fn(src, flow, k, gz, it, dk)
            devs[name] = max(
                float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
                for a, r in zip(got, ref))
        del ref
        times = cuda_ms([lambda fn=fn: fn(src, flow, k, gz, it, dk)
                         for fn in fns.values()], args.reps)
        for (name, dv), ms in zip(devs.items(), times):
            line = dict(kernel="iac_bwd", variant=name, it=it,
                        shape=[args.b, h, w, src.shape[-1]], ms=ms,
                        rel_dev=dv, bar=BWD_BAR, held=dv <= BWD_BAR,
                        card=name_card)
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


@torch.no_grad()
def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="?", default="{}",
                    help="JSON {name: [[old, new], ...] or a directory}")
    ap.add_argument("--takeouts", action="store_true")
    ap.add_argument("--chain", action="store_true",
                    help="the resident chain's kernel (K4) instead of K1's")
    ap.add_argument("--bwd", action="store_true",
                    help="the adjoint's kernel (K5) instead of K1's")
    ap.add_argument("--parent", help="another checkout's csrc/ directory")
    ap.add_argument("--shapes", nargs="+",
                    default=["mat:f32:1", "kf:f32:1", "kf:bf16:2"])
    ap.add_argument("--hw", default=None,
                    help="H x W (default 272x480; with --bwd 128x128)")
    ap.add_argument("--its", nargs="+", type=int, default=[0, 5],
                    help="--bwd: the iterations timed")
    ap.add_argument("--b", type=int, default=6, help="--bwd: the batch")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if args.chain and (args.parent or args.bwd):
        raise SystemExit("iac_ab: --chain takes neither --parent nor --bwd")
    runs = variants(args.takeouts, args.parent, json.loads(args.variants),
                    args.chain, args.bwd)
    if not runs:
        raise SystemExit("iac_ab: no variant (give JSON, --takeouts or "
                         "--parent)")
    if args.bwd:
        return _main_bwd(args, runs)
    args.hw = args.hw or "272x480"
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
