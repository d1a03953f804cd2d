"""An A/B of the deformable conv's kernel (K7, ``csrc/dcn.cu``) or its
adjoint's (K8, ``csrc/dcn_bwd.cu``) against edited copies of itself and
against another checkout's, on the card.

    python -m fcvsr_tpu_torch.benchmarks.dcn_ab [--bwd] [--takeouts] \\
        [--parent DIR] ['{"name": [[old, new], ...]}'] \\
        [--shapes edvr_l1 bvsr_serve bvsr_train edvr_train] [--reps 7]

A variant is the tree's source with each ``old`` text replaced by ``new``
(an edit ``["dcn.cuh", old, new]`` edits the shared sampler, which both
kernels include), or a directory's path, whose source and headers are
built instead, or ``{"dir": DIR, "edits": [...]}``, that directory's
files edited.  ``--takeouts`` adds
the tree's kernel (``base``) and the edits that take a piece out
(:data:`TAKEOUTS` for K7, :data:`BWD_TAKEOUTS` for K8).  ``--parent DIR``
adds another checkout's ``csrc/`` (``parent``): K7's entry point is the
same in both; K8's two-launch entry points (``fcvsr_dcn3x3_bwd_data``
and ``_weight``, into five zeroed buffers) are found and called as that
checkout's wrapper did.  An edit whose ``old`` text is missing raises.
nvcc builds every variant at once, the source alone into a library of its
own under ``_build/dcn_ab/<name>/`` (``_native.build_variants``), and
ptxas's registers and spills of each kernel are printed.

A shape is one of :data:`SHAPES`, the zoo's timed cases (chip_smoke.py's):
EDVR-M's level 1 over a 5-frame 180x320 window and its 20x64x64 training
batch (64 -> 64, 8 deform groups), BasicVSR++'s alignment at 192x320 and
at its 64x64 training frame (128 -> 64, 16 groups), all with a mask and a
bias, inputs seeded as chip_smoke.py draws them (offsets small, +-20 px
in the top third, out of the frame at the bottom and the left).  Each
variant runs once and is held to the plain version: K7 its max deviation
over max(1, max|plain|), K8 each gradient's over its own max, beside the
bar 1e-4 (a takeout misses it); then the variants are timed in turns
(``profiling.cuda_ms``, the median of ``--reps``; K8 a call with its
buffers' zeroing).  One JSON line a variant and shape.  A CUDA device is
needed.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..ops import _native, fused_dcn
from ..ops.dcn import modulated_deform_conv2d, modulated_deform_conv2d_vjp
from ..profiling import card, cuda_ms, need_device

__all__ = ["SOURCE", "BWD_SOURCE", "SHAPES", "TAKEOUTS", "BWD_TAKEOUTS",
           "variants", "main"]

SOURCE = "dcn.cu"
BWD_SOURCE = "dcn_bwd.cu"
BAR = 1e-4
# name -> (B, H, W, Cin, Cout, deform groups)
SHAPES = {
    "edvr_l1": (5, 180, 320, 64, 64, 8),
    "bvsr_serve": (1, 192, 320, 128, 64, 16),
    "bvsr_train": (1, 64, 64, 128, 64, 16),
    "edvr_train": (20, 64, 64, 64, 64, 8),
}
# the tree's kernels with a piece taken out: K7's gather (the corners'
# loads; the sample points stay), its wgmma, its weight fill (the loads
# and splits of a step's weight slice)
TAKEOUTS = {
    "no_gather": [["load_quad(v, x, pt, Cin, c);",
                   "for (int q = 0; q < 4; ++q) v[q] = make_float4(pt.wt[q], pt.wt[q], "
                   "pt.wt[q], pt.wt[q]);"]],
    "no_mma": [["mma_bf16x3<kNo, kCk / 16, 0, 0>(",
                "if (N < 0) mma_bf16x3<kNo, kCk / 16, 0, 0>("]],
    "no_wfill": [["load_weights(wv, w, Cin, Cout, q / nck, (q % nck) * kCk, co0);",
                  "for (int i = 0; i < kWItems; ++i) for (int e = 0; e < 8; ++e) "
                  "wv[i][e] = 0.01f;"]],
}
# K8's: the u product, the dx scatter's atomics, the doffset and dmask
# sums and stores, the weight adjoint's wgmma
BWD_TAKEOUTS = {
    "no_u": [["mma_bf16x3<kNu, COUTP / 16, 0, 0>(",
              "if (N < 0) mma_bf16x3<kNu, COUTP / 16, 0, 0>("]],
    "no_scatter": [["scatter_quad(dx, pt, Cin, c, vv);",
                    "if (vv.x == 12345.f) dx[c] = vv.y;"]],
    "no_offsets": [["store_offsets(doffset, dmask, n, grp, tap, dg, dm, dpy, dpx, zeroed);",
                    "if (dm == 12345.f) doffset[0] = dpy + dpx;"]],
    "no_dw": [["mma_bf16x3<kNw, kTileB / 16, 1, 1>(",
               "if (N < 0) mma_bf16x3<kNw, kTileB / 16, 1, 1>("]],
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the entry points of K8's two-launch version (before the tensor cores)
_TWO_LAUNCH = {
    "fcvsr_dcn3x3_bwd_data": [_P] * 8 + [_I] * 6 + [_P],
    "fcvsr_dcn3x3_bwd_weight": [_P] * 6 + [_I] * 6 + [_P],
}


def variants(takeouts: bool, parent: str | None, extra: dict,
             bwd: bool = False) -> dict:
    """{name: edits} of the runs asked for (see the module's note)."""
    out = {}
    if takeouts:
        out["base"] = []
        out.update(BWD_TAKEOUTS if bwd else TAKEOUTS)
    if parent:
        out["parent"] = parent
    out.update(extra)
    return out


def _checked(fn, name):
    def call(*args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed: CUDA error {rc}")
        return 0
    return call


def _build(runs: dict, bwd: bool) -> dict:
    """{name: a callable computing the variant's function from the case's
    inputs}; ptxas's registers and spills of each kernel printed."""
    source = BWD_SOURCE if bwd else SOURCE
    built = _native.build_variants("dcn_ab", source, runs, None, None,
                                   flags=("-Xptxas=-v",))
    fns = {}
    for name, (handle, out) in built.items():
        lines = out.splitlines()
        usage = [f"{lines[i - 1].strip()} | {line.strip()}"
                 for i, line in enumerate(lines)
                 if "Used" in line and i > 1 and "_kernel" in lines[i - 2]]
        print(json.dumps(dict(variant=name, ptxas=usage)), flush=True)
        fns[name] = _bind(handle, name, bwd)
    return fns


def _bind(handle, name: str, bwd: bool):
    if not bwd:
        fn = handle.fcvsr_dcn3x3
        fn.argtypes, fn.restype = _native._SIGNATURES["fcvsr_dcn3x3"], _I
        fn = _checked(fn, name)
        return lambda c: fused_dcn.launch_forward(
            fn, c["x"], c["off"], c["mask"], c["w"], c["b"], c["dg"])
    if not hasattr(handle, "fcvsr_dcn3x3_bwd_data"):
        fn = handle.fcvsr_dcn3x3_bwd
        fn.argtypes, fn.restype = _native._SIGNATURES["fcvsr_dcn3x3_bwd"], _I
        fn = _checked(fn, name)
        return lambda c: fused_dcn.launch_adjoint(
            fn, c["x"], c["off"], c["mask"], c["w"], True, c["g"], c["dg"])
    two = {}
    for entry, argtypes in _TWO_LAUNCH.items():
        fn = getattr(handle, entry)
        fn.argtypes, fn.restype = argtypes, _I
        two[entry] = _checked(fn, name)
    return lambda c: _two_launch(two, c)


def _two_launch(fns, c):
    """K8 as the two-launch version's wrapper called it: five zeroed
    buffers, the data adjoint, then the weight adjoint."""
    x, off, mask, w, g = c["x"], c["off"], c["mask"], c["w"], c["g"]
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    dx, doff, dw = (torch.zeros_like(t) for t in (x, off, w))
    dmask = torch.zeros_like(mask)
    db = w.new_zeros(cout)
    with _native.launch_guard(x) as stream:
        fns["fcvsr_dcn3x3_bwd_data"](
            x.data_ptr(), off.data_ptr(), mask.data_ptr(), w.data_ptr(),
            g.data_ptr(), dx.data_ptr(), doff.data_ptr(), dmask.data_ptr(),
            b, h, wd, cin, cout, c["dg"], stream)
        fns["fcvsr_dcn3x3_bwd_weight"](
            x.data_ptr(), off.data_ptr(), mask.data_ptr(), g.data_ptr(),
            dw.data_ptr(), db.data_ptr(), b, h, wd, cin, cout, c["dg"],
            stream)
    return dx, doff, dmask, dw, db


def mixed_offsets(rng, b, h, w, c):
    """Offsets as chip_smoke.py draws them: N(0, 1.5) px, +-20 px in the
    top third, out of the frame at the bottom and the left edge."""
    off = rng.standard_normal((b, h, w, c)) * 1.5
    off[:, : h // 3] = rng.uniform(-20, 20, (b, h // 3, w, c))
    off[:, -max(1, h // 6):, :, 0::2] += 600.0
    off[:, :, : max(1, w // 8), 1::2] -= 400.0
    return off


def case(name: str, dev) -> dict:
    """The seeded inputs of shape ``name``."""
    b, h, w, cin, cout, dg = SHAPES[name]
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return dict(
        x=t(rng.standard_normal((b, h, w, cin))),
        off=t(mixed_offsets(rng, b, h, w, dg * 18)),
        mask=t(1 / (1 + np.exp(-rng.standard_normal((b, h, w, dg * 9))))),
        w=t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)),
        b=t(rng.standard_normal(cout) * 0.1),
        g=t(rng.standard_normal((b, h, w, cout))), dg=dg)


def _plain(c, bwd: bool):
    if bwd:
        return modulated_deform_conv2d_vjp(c["x"], c["off"], c["mask"],
                                           c["w"], c["b"], c["g"], c["dg"])
    return modulated_deform_conv2d(c["x"], c["off"], c["mask"], c["w"],
                                   c["b"], deform_groups=c["dg"])


def _dev(got, ref, bwd: bool) -> float:
    """K7: max deviation over max(1, max|plain|); K8: the largest of each
    gradient's max deviation over its own max."""
    if not bwd:
        return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
    return max(float((a - r).abs().max()) / float(r.abs().max())
               for a, r in zip(got, ref))


@torch.no_grad()
def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="?", default="{}",
                    help="JSON {name: [[old, new], ...] or a directory}")
    ap.add_argument("--bwd", action="store_true",
                    help="the adjoint's kernel (K8) instead of K7")
    ap.add_argument("--takeouts", action="store_true")
    ap.add_argument("--parent", help="another checkout's csrc/ directory")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES))
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    runs = variants(args.takeouts, args.parent, json.loads(args.variants),
                    args.bwd)
    if not runs:
        raise SystemExit("dcn_ab: no variant (give JSON, --takeouts or "
                         "--parent)")
    dev = need_device("cuda")
    fns = _build(runs, args.bwd)
    lines, name_card = [], card()
    for shape in args.shapes:
        c = case(shape, dev)
        ref = _plain(c, args.bwd)
        devs = {name: _dev(fn(c), ref, args.bwd) for name, fn in fns.items()}
        del ref
        times = cuda_ms([lambda fn=fn: fn(c) for fn in fns.values()],
                        args.reps)
        for (name, dv), ms in zip(devs.items(), times):
            line = dict(kernel="dcn_bwd" if args.bwd else "dcn",
                        variant=name, shape=shape, dims=SHAPES[shape], ms=ms,
                        rel_dev=dv, bar=BAR, held=dv <= BAR, card=name_card)
            print(json.dumps(line), flush=True)
            lines.append(line)
        del c
    return lines


if __name__ == "__main__":
    main()
