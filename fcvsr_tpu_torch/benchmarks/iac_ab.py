"""An A/B of the IAC iteration's kernel (K1, ``csrc/iac.cu``) against
edited copies of itself, on the card: K1 taken apart.

    python -m fcvsr_tpu_torch.benchmarks.iac_ab [--takeouts] \\
        [--parent DIR] ['{"name": [[old, new], ...]}'] \\
        [--shapes mat:f32:1 kf:bf16:2] [--hw 272x480] [--reps 7]

A variant is the tree's ``iac.cu`` with each ``old`` text replaced by
``new`` (an edit ``["iac_tile.cuh", old, new]`` edits that header), or a
directory's path, whose ``iac.cu`` and headers are built instead, or
``{"dir": DIR, "edits": [...]}``, that directory's files edited.
``--takeouts`` adds the tree's kernel (``base``) and the three edits that
take a piece out (:data:`TAKEOUTS`): the gather's loads (``no_gather``),
the kernel stream or the prediction (``no_stream``: no materialised
kernel loads, no mma), the passes' shared-memory reads and shuffles
(``no_passes``).  ``--parent DIR`` adds the kernel of another checkout's
``csrc/`` (the design before the redesign: one block a 16-channel chunk of
an 8x16 tile, element loads, the kf prediction on the float32 pipes), and
with ``--takeouts`` its own three takeouts (:data:`PARENT_TAKEOUTS`).  An
edit whose ``old`` text is missing raises.  nvcc builds every variant at
once, ``iac.cu`` alone into a library of its own under
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
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import _native, fused_iac
from ..profiling import card, cuda_ms, need_device

__all__ = ["SOURCE", "TAKEOUTS", "PARENT_TAKEOUTS", "variants", "main"]

SOURCE = "iac.cu"
BARS = {"f32": 2e-5, "bf16": 1.6e-2}
# the tree's kernel with a piece taken out
TAKEOUTS = {
    "no_gather": [
        ["load8(a[i], featb + (size_t)c.off[i] * C + grp * 8, C - grp * 8, vec);",
         "for (int j = 0; j < 8; ++j) a[i][j] = c.wt[i];"]],
    "no_stream": [
        ["for (int t = 0; t < 3; ++t) kr[t][h] = load2(kp + t * C, C - ch, pairs);",
         "for (int t = 0; t < 3; ++t) kr[t][h] = load2(kp, 0, pairs);"],
        ["            mma<T>(acc[t], ah, bh[t][s]);\n"
         "            mma<T>(acc[t], ah, bl[t][s]);\n"
         "            if constexpr (sizeof(T) == 4) mma<T>(acc[t], al, bh[t][s]);",
         "            acc[t][0] += __uint_as_float(ah[0]);"]],
    "no_passes": [
        ["const float2 wv = *reinterpret_cast<const float2*>(wp + t * MP * CP);",
         "const float2 wv = make_float2(1.f, 1.f);"],
        ["        const float nx0 = __shfl_sync(0xffffffffu, v[0][e], (lane + 4) & 31);\n"
         "        const float nx1 = __shfl_sync(0xffffffffu, v[1][e], (lane + 4) & 31);\n"
         "        const float pv0 = __shfl_sync(0xffffffffu, v[0][e], (lane + 28) & 31);\n"
         "        const float pv1 = __shfl_sync(0xffffffffu, v[1][e], (lane + 28) & 31);",
         "        const float nx0 = v[0][e], nx1 = v[1][e], pv0 = v[0][e], pv1 = v[1][e];"]],
}
# the same pieces of the kernel before its redesign (its iac_tile.cuh)
PARENT_TAKEOUTS = {
    "no_gather": [
        ["iac_tile.cuh",
         "      val = tap(iy, ix) * ((1.f - fy) * (1.f - fx));\n"
         "      val += tap(iy, ix + 1) * ((1.f - fy) * fx);\n"
         "      val += tap(iy + 1, ix) * (fy * (1.f - fx));\n"
         "      val += tap(iy + 1, ix + 1) * (fy * fx);",
         "      val = fx + fy;"]],
    "no_stream": [
        ["iac_tile.cuh",
         "        for (int ci = 0; ci < c0; ++ci) val += to_f32(fp[ci]) * "
         "w_s[(ci * 3 + t) * CC + ch];",
         "        val += to_f32(fp[0]);"],
        ["iac_tile.cuh",
         "        val = to_f32(k[pix * k_ld + k_off + t * C + ch0 + ch]);",
         "        val = 0.1f * (t + 1);"]],
    "no_passes": [
        ["iac_tile.cuh",
         "for (int t = 0; t < 3; ++t) s += warp_s[((r + t) * HC + cc) * CC + ch] * kk[t * CC];",
         "s = kk[0];"],
        ["iac_tile.cuh",
         "for (int t = 0; t < 3; ++t) s += v_s[(r * HC + j + t) * CC + ch] * kk[t * CC];",
         "s = kk[CC];"]],
}


def variants(takeouts: bool, parent: str | None, extra: dict) -> dict:
    """{name: edits} of the runs asked for (see the module's note)."""
    out = {}
    if takeouts:
        out["base"] = []
        out.update(TAKEOUTS)
    if parent:
        out["parent"] = parent
        if takeouts:
            out.update({f"parent_{k}": {"dir": parent, "edits": v}
                        for k, v in PARENT_TAKEOUTS.items()})
    out.update(extra)
    return out


def _build(runs: dict) -> dict:
    """{name: (fcvsr_iac_step of the variant, whether it takes Wsel's bf16
    planes)}; ptxas's registers and spills of each kernel printed."""
    built = _native.build_variants(
        "iac_ab", SOURCE, runs, "fcvsr_iac_step",
        _native._SIGNATURES["fcvsr_iac_step"], flags=("-Xptxas=-v",))
    libs = {}
    for name, (fn, out) in built.items():
        lines = out.splitlines()
        usage = [f"{lines[i - 1].strip()} | {line.strip()}"
                 for i, line in enumerate(lines)
                 if "Used" in line and i > 1 and "iac_kernel" in lines[i - 2]]
        print(json.dumps(dict(variant=name, ptxas=usage)), flush=True)
        text = _native.edited_sources(SOURCE, runs[name])[SOURCE]
        libs[name] = (fn, "wpl" in text)
    return libs


def _case(spec: str, h: int, w: int, dev):
    """'kf:bf16:2' -> (mode, storage, inputs) at h x w x 64, C0 64."""
    mode, storage, b = spec.split(":")
    b, c, n_it = int(b), 64, 6
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
    return mode, storage, ins


def _plain(mode, ins):
    c = ins["feat"].shape[-1]
    k = ins["k"] if mode == "mat" else fused_iac.predict_kernels(
        ins["f0"], ins["wsel"], ins["bsel"], 0, c)
    return fused_iac.warp_sac_plain(ins["feat"], ins["flow"], k, ins["fin"])


def _runner(fn, planes_abi: bool, mode, ins):
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
    ap.add_argument("--parent", help="another checkout's csrc/ directory")
    ap.add_argument("--shapes", nargs="+",
                    default=["mat:f32:1", "kf:f32:1", "kf:bf16:2"])
    ap.add_argument("--hw", default="272x480")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    runs = variants(args.takeouts, args.parent, json.loads(args.variants))
    if not runs:
        raise SystemExit("iac_ab: no variant (give JSON, --takeouts or "
                         "--parent)")
    dev = need_device("cuda")
    libs = _build(runs)
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
        times = cuda_ms(list(fns.values()), args.reps)
        for (name, dv), ms in zip(devs.items(), times):
            line = dict(variant=name, shape=spec, hw=args.hw, ms=ms,
                        rel_dev=dv, bar=BARS[storage],
                        held=dv <= BARS[storage], card=name_card)
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
