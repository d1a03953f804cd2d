#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``fcvsr_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line or more each:
  1. device and build: the card's name and power limit (nvidia-smi), torch
     and CUDA versions, the nvcc build of ``fcvsr_tpu_torch/csrc`` (one nvcc
     a source, in parallel);
  2. every kernel of the serving and training paths against its plain
     PyTorch version on the card, at the shapes FCVSR and the zoo give it,
     with the max abs error against the stated tolerance, both CUDA-event
     times (median of 7 after 2 warm-ups, the versions timed in turns) and
     the least time the card could take: the IAC iteration (K1) and the
     conv kernels (K2, K3) at the serving shape, the IAC adjoint (K5) at the
     training shape and at small odd shapes, the deformable conv (K7) at
     EDVR-M's and BasicVSR++'s shapes, without a mask and at small odd
     shapes, and the conv autograd Functions' gradients at the three SCNet
     levels;
  3. model parity, seeded weights, the GPU (kernels) against the same model
     on the CPU (plain versions): FCVSR full, Y, the output at
     (1, 7, 1, 64, 96) and ``loss.backward()``'s gradients at (1, 7, 1, 32,
     48), per parameter tensor; EDVR-M and BasicVSR++ at full width, with
     their offset convs seeded non-zero, the output at (1, 5, 3, 64, 96) and
     the DCN launches per forward;
  4. serving: ``fcvsr_tpu_torch.cli`` evaluates a synthetic 10-frame 480x270
     clip on preset fcvsr_cvcpLD_QP22 (270 -> 272 pad, output crop, PSNR /
     SSIM), with the kernel launch counts per frame checked, then ``--fps``
     at 1 x 7 x 1 x 272 x 480;
  5. zoo serving: ``apis.restoration_video_inference`` restores a synthetic
     10-frame RGB clip with EDVR-M (180x320, 5-frame windows) and BasicVSR++
     (192x320, the whole clip in one recurrent forward); shapes, finite
     values and DCN launches per forward, checked; ms per restored frame
     (``cli.fps_benchmark``) and peak memory;
  6. training: ``fcvsr_tpu_torch.train.cli`` trains the same preset (batch
     6, 128x128 LR patches from the clip, Adam, Charbonnier-sum) for one
     warm-up step, then resumes from its checkpoint for 5 timed steps; the
     losses, ms per step, peak memory and launch counts per step, checked;
  7. a JSON line of the kernels (launches from the run of the path that
     launches each: training for FCVSR's, zoo serving for the DCN; each
     kernel's least time on the card from its bytes and operations), the
     nvidia-smi line, and the result line.

Any failure exits non-zero without a result line; so does a run without a
CUDA device or outside the repository.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PRESET = "fcvsr_cvcpLD_QP22"
# per frame of the full Y model: 6 iterations x 2 directions x 3 MGAA calls;
# 2 pairs x 3 BlockRCBs x 3 levels x 10 groups; 3 group convs x 10 + conv_last0
PER_FRAME = {"iac": 36, "iac_bwd": 0, "conv3x3_pair": 180, "conv3x3": 31,
             "dcn": 0}
# per training step: the forward's launches; the IAC adjoint is two
# launches an iteration; each pair's backward rebuilds its intermediate
# with one conv3x3 launch
PER_STEP = {"iac": 36, "iac_bwd": 72, "conv3x3_pair": 180, "conv3x3": 211,
            "dcn": 0}
ZOO_T = 10  # frames of the zoo's serving clip


def dcn_per_forward(model: str, t: int) -> int:
    """DCN launches a forward of t frames: EDVR's levels 3, 2, 1 and the
    cascade, once each (T folded into the batch); BasicVSR++'s 4 branches
    at every frame but the first of each."""
    return 4 if model == "EDVRNet" else 4 * (t - 1)


KERNELS = {
    "iac": ("fcvsr_tpu_torch/csrc/iac.cu", "fcvsr_tpu/ops/pallas_iac.py:98"),
    "conv3x3_pair": ("fcvsr_tpu_torch/csrc/conv3x3.cu",
                     "fcvsr_tpu/ops/pallas_conv.py:236"),
    "conv3x3": ("fcvsr_tpu_torch/csrc/conv3x3.cu",
                "fcvsr_tpu/ops/pallas_conv.py:108"),
    "iac_bwd": ("fcvsr_tpu_torch/csrc/iac_bwd.cu",
                "fcvsr_tpu/ops/pallas_iac.py:926"),
    "dcn": ("fcvsr_tpu_torch/csrc/dcn.cu", "fcvsr_tpu/ops/pallas_dcn.py:58"),
}
# f32 kernels against f32 plain versions that sum in another order: the
# bound scales with the output's magnitude (IAC: 3x3 taps of a warped value
# and a 64-term kernel dot in kf mode; convs: up to 1152-term dot products;
# the IAC adjoint: dflow sums 64 channels, dsrc sums by atomics in an order
# that changes from run to run; conv gradients: sums over every pixel)
IAC_RTOL = 2e-5
IAC_BWD_RTOL = 1e-5
CONV_RTOL = 1e-4
# GPU vs CPU model output in [0, 1]: well under one 8-bit grey level (3.9e-3)
MODEL_ATOL = 1e-3
# GPU vs CPU gradients, relative to their norm.  The whole gradient and the
# median tensor are held to GRAD_RTOL, the per-tensor bar of the CPU test
# against JAX; each tensor to FLIP_RTOL.  At f32 noise the gradient is not a
# continuous function of the inputs: a (leaky) relu whose input lies within
# that noise of 0 takes the other branch, and a flow within it of an integer
# (the random model's flows sit near 0) moves the warp's floor.  The phase
# measures that floor on the CPU (the same step with the input moved by 1e-6
# of itself) and prints it beside the GPU's deviation.  A gradient that is
# missing, or wrong in a kernel, is off by its own size.
GRAD_RTOL = 1e-3
FLIP_RTOL = 5e-2
# NVIDIA's published H100 SXM peaks (data sheet): HBM bytes/s and float32
# flop/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fns, reps: int = 7, warmup: int = 2):
    """Median CUDA-event ms of each callable, the callables timed in turns."""
    for f in fns:
        for _ in range(warmup):
            f()
    times = [[] for _ in fns]
    for _ in range(reps):
        for f, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def bound(nbytes: float, flops: float):
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, the larger; and which one it is."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mixed_flows(rng, b, h, w, c=2):
    """Small displacements, +-20 px in the top third, out of the frame at
    the bottom and at the left edge: c channels of (first, second) axis
    pairs, a flow's (dx, dy) or a DCN offset's (dy, dx) per tap."""
    flow = rng.standard_normal((b, h, w, c)) * 1.5
    flow[:, : h // 3] = rng.uniform(-20, 20, (b, h // 3, w, c))
    flow[:, -max(1, h // 6):, :, 0::2] += 600.0
    flow[:, :, : max(1, w // 8), 1::2] -= 400.0
    return flow


def phase_kernels(torch, dev):
    import torch.nn.functional as F

    from fcvsr_tpu_torch.ops import fused_conv, fused_dcn, fused_iac
    from fcvsr_tpu_torch.ops.dcn import modulated_deform_conv2d

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    results = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def check(name, label, kern, plain, rtol, work=None, library=None):
        """Kernel against plain version; a tuple of outputs is checked one
        by one.  ``work`` = (bytes, flops) marks a timed case, with its
        bound; the first such case of a kernel goes into the result line."""
        outs, refs = kern(), plain()
        if isinstance(outs, torch.Tensor):
            outs, refs = (outs,), (refs,)
        torch.cuda.synchronize()
        errs = [float((o - r).abs().max()) for o, r in zip(outs, refs)]
        tols = [rtol * max(1.0, float(r.abs().max())) for r in refs]
        line = dict(kernel=name, case=label, max_abs_err=errs, tol=tols)
        if work is not None:
            fns = [kern, plain] + ([library] if library else [])
            times = cuda_ms(torch, fns)
            bound_ms, bound_by = bound(*work)
            line.update(ms=times[0], plain_ms=times[1], bound_ms=bound_ms,
                        bound_by=bound_by,
                        library_ms=times[2] if library else None)
            if "ms" not in results[name]:
                results[name].update((k, line[k]) for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"))
        say("kernels", **line)
        for e, tol in zip(errs, tols):
            if not e <= tol:
                fail(f"{name} {label}: max abs error {e} > {tol}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           *errs)

    # IAC at the FCVSR shape: B=1, C=64, 272x480, 6 iterations of kernels;
    # flows mix small, +-20 px and out-of-frame displacements
    b, h, w, c, n_it = 1, 272, 480, 64, 6
    feat = t(rng.standard_normal((b, h, w, c)))
    fin = t(rng.standard_normal((b, h, w, c)))
    flow = t(mixed_flows(rng, b, h, w))
    k = t(rng.standard_normal((b, h, w, n_it * 3 * c)) * 0.3)
    f0 = t(rng.standard_normal((b, h, w, c)))
    wsel = t(rng.standard_normal((c, n_it * 3 * c)) * 0.1)
    bsel = t(rng.standard_normal((n_it * 3 * c,)) * 0.1)
    # the materialised-kernel variant first: it is the one the slice serves,
    # so its times are the ones the result line reports.  Work: feat, flow,
    # the 3C kernels and feat_in read, out written; ~22 flops a value (the
    # 4-corner warp, two 3-tap passes, residual, activation)
    px = b * h * w
    iac_work = (4 * px * (6 * c + 2), 22 * px * c)
    for it, act in ((0, True), (5, False)):
        check("iac", f"materialised it={it} act={act} 272x480x64",
              lambda: fused_iac.warp_sac_fused(feat, flow, k, fin, act, it),
              lambda: fused_iac.warp_sac_plain(feat, flow, k, fin, act, it),
              IAC_RTOL, work=iac_work if it == 0 else None)
        check("iac", f"kf it={it} act={act} 272x480x64",
              lambda: fused_iac.warp_sac_fused_kf(feat, flow, f0, wsel, bsel,
                                                  fin, act, it),
              lambda: fused_iac.warp_sac_plain(
                  feat, flow, fused_iac.predict_kernels(f0, wsel, bsel, it, c),
                  fin, act),
              IAC_RTOL, work=(4 * px * (4 * c + 2), (22 + 6 * c) * px * c)
              if it == 0 else None)
    del feat, fin, flow, k, f0

    # SCNet convs at its three levels.  Work: x read, out (and res) written
    # once, the weights; 2 flops a multiply-add
    def conv_work(px, *chans):
        macs = sum(9 * a * b for a, b in zip(chans, chans[1:]))
        return (4 * (px * (chans[0] + chans[-1]) + macs), 2 * px * macs)

    for (h, w) in ((272, 480), (136, 240), (68, 120)):
        px = h * w
        x = t(rng.standard_normal((1, h, w, 64)))
        w1 = t(rng.standard_normal((3, 3, 64, 128)) * 0.04)
        b1 = t(rng.standard_normal(128) * 0.1)
        w2 = t(rng.standard_normal((3, 3, 128, 64)) * 0.03)
        b2 = t(rng.standard_normal(64) * 0.1)
        check("conv3x3_pair", f"64->128->64 bias ns0.1 {h}x{w}",
              lambda: fused_conv.conv3x3_pair(x, w1, b1, w2, b2, 0.1),
              lambda: fused_conv.conv3x3_pair_plain(x, w1, b1, w2, b2, 0.1),
              CONV_RTOL, work=conv_work(px, 64, 128, 64) if h == 272 else None)
        r1 = t(rng.standard_normal((3, 3, 64, 64)) * 0.04)
        r2 = t(rng.standard_normal((3, 3, 64, 64)) * 0.04)
        check("conv3x3_pair", f"64->64->64 nobias ns0.2 {h}x{w}",
              lambda: fused_conv.conv3x3_pair(x, r1, None, r2, None, 0.2),
              lambda: fused_conv.conv3x3_pair_plain(x, r1, None, r2, None,
                                                    0.2),
              CONV_RTOL, work=conv_work(px, 64, 64, 64) if h == 272 else None)
        res = t(rng.standard_normal((1, h, w, 64)))
        rw = conv_work(px, 64, 64)
        # the library yardstick: one cuDNN conv with bias (no residual)
        check("conv3x3", f"64->64 +res {h}x{w}",
              lambda: fused_conv.conv3x3(x, r1, b2, res=res),
              lambda: fused_conv.conv3x3_plain(x, r1, b2, res=res),
              CONV_RTOL,
              work=(rw[0] + 4 * px * 64, rw[1]) if h == 272 else None,
              library=lambda: F.conv2d(x.permute(0, 3, 1, 2),
                                       r1.permute(3, 2, 0, 1), b2, padding=1))
    x = t(rng.uniform(-1, 1, (1, 1088, 1920, 64)))
    wl = t(rng.standard_normal((3, 3, 64, 1)) * 0.04)
    bl = t(rng.standard_normal(1))
    check("conv3x3", "64->1 conv_last0 1088x1920",
          lambda: fused_conv.conv3x3(x, wl, bl),
          lambda: fused_conv.conv3x3_plain(x, wl, bl), CONV_RTOL,
          work=conv_work(1088 * 1920, 64, 1))
    del x

    # the IAC adjoint (K5) at the training shape: B=6, 128x128, C=64, its
    # dk written into one buffer as the chain does; the cotangent masked by
    # the activation (it 0) or not (it 5).  Work: src, flow, the 3C kernels
    # and gz read, dk, dflow and dsrc written; ~40 flops a value
    b, h, w, c = 6, 128, 128, 64
    px = b * h * w
    src = t(rng.standard_normal((b, h, w, c)))
    flow = t(mixed_flows(rng, b, h, w))
    k = t(rng.standard_normal((b, h, w, n_it * 3 * c)) * 0.3)
    g = t(rng.standard_normal((b, h, w, c)))
    for it, act in ((0, True), (5, False)):
        gz = torch.where(src > 0, g, 0.1 * g) if act else g
        dk = torch.zeros_like(k)
        check("iac_bwd", f"it={it} act={act} 6x128x128x64",
              lambda: fused_iac.warp_sac_bwd(src, flow, k, gz, it, dk),
              lambda: fused_iac.warp_sac_vjp_plain(src, flow, k, gz, it),
              IAC_BWD_RTOL,
              work=(4 * px * (9 * c + 4), 40 * px * c) if it == 0 else None)
    del src, flow, k, g, dk, gz
    # and at small odd shapes: tiles cut at the frame's edges, channel
    # chunks cut short
    for (h, w, c) in ((5, 7, 8), (13, 29, 20)):
        src = t(rng.standard_normal((2, h, w, c)))
        flow = t(mixed_flows(rng, 2, h, w))
        k = t(rng.standard_normal((2, h, w, 3 * 3 * c)) * 0.3)
        gz = t(rng.standard_normal((2, h, w, c)))
        check("iac_bwd", f"it=1 2x{h}x{w}x{c}",
              lambda: fused_iac.warp_sac_bwd(src, flow, k, gz, 1),
              lambda: fused_iac.warp_sac_vjp_plain(src, flow, k, gz, 1),
              IAC_BWD_RTOL)
    del src, flow, k, gz

    # the deformable conv (K7) at EDVR-M's level 1 (the 5 frames of a REDS
    # window, 64 -> 64, 8 deform groups) and BasicVSR++'s alignment (128 ->
    # 64, 16 groups), offsets mixed as the flows above; without a mask; at
    # small odd shapes.  Work: x, offsets, mask and weights read, out
    # written; 2 flops a multiply-add of the 9 * Cin * Cout contraction and
    # 8 a sampled value (4 corner products and their sum, the weights).  The
    # library yardstick is cuDNN's conv of the same shapes, the zero-offset
    # special case
    for (b, h, w, cin, cout, dg, with_mask, timed) in (
            (5, 180, 320, 64, 64, 8, True, True),
            (1, 192, 320, 128, 64, 16, True, True),
            (2, 64, 96, 64, 64, 8, False, False),
            (2, 13, 29, 24, 40, 3, True, False),
            (1, 5, 7, 8, 70, 1, True, False)):
        x = t(rng.standard_normal((b, h, w, cin)))
        off = t(mixed_flows(rng, b, h, w, dg * 18))
        mask = t(1 / (1 + np.exp(-rng.standard_normal((b, h, w, dg * 9))))) \
            if with_mask else None
        wd = t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
        bd = t(rng.standard_normal(cout) * 0.1)
        px = b * h * w
        work = (4 * (px * (cin + dg * 18 + (dg * 9 if with_mask else 0)
                           + cout) + 9 * cin * cout + cout),
                px * 9 * cin * (2 * cout + 8))
        check("dcn", f"{b}x{h}x{w} {cin}->{cout} dg{dg} "
              f"{'v2' if with_mask else 'v1'}",
              lambda: fused_dcn.modulated_deform_conv2d_fused(
                  x, off, mask, wd, bd, deform_groups=dg),
              lambda: modulated_deform_conv2d(x, off, mask, wd, bd,
                                              deform_groups=dg),
              CONV_RTOL, work=work if timed else None,
              library=lambda: F.conv2d(x.permute(0, 3, 1, 2),
                                       wd.permute(3, 2, 0, 1), bd, padding=1))
    del x, off, mask
    return results


def phase_conv_grads(torch, dev):
    """The conv autograd Functions' gradients against autograd through the
    plain versions, at SCNet's three levels of a training batch.

    The pair's backward masks its leaky relu by the intermediate that the
    conv3x3 kernel rebuilds; cuDNN's intermediate differs from it by f32
    noise, so the few values within that noise of 0 (~10 of 12.6M at
    6x128x128x128) take the other branch.  The plain reference therefore
    takes its mask from the kernel's intermediate (its values stay cuDNN's),
    and the line reports how many signs differ."""
    from fcvsr_tpu_torch.ops import fused_conv

    rng = np.random.default_rng(3)
    flips = []

    def pair_plain(x, w1, b1, w2, b2, ns1):
        with torch.no_grad():
            pos = fused_conv.conv3x3(x.detach(), w1.detach(),
                                     None if b1 is None else b1.detach(),
                                     act=True, neg_slope=ns1) > 0
        pre = fused_conv.conv3x3_plain(x, w1, b1)
        flips.append(int((pos != (pre > 0)).sum()))
        return fused_conv.conv3x3_plain(torch.where(pos, pre, ns1 * pre), w2,
                                        b2)

    def t(shape, scale=1.0):
        a = rng.standard_normal(shape) * scale
        return torch.from_numpy(a.astype(np.float32)).to(dev).requires_grad_()

    for (h, w) in ((128, 128), (64, 64), (32, 32)):
        x = t((6, h, w, 64))
        w1, b1 = t((3, 3, 64, 128), 0.04), t((128,), 0.1)
        w2, b2 = t((3, 3, 128, 64), 0.03), t((64,), 0.1)
        r1, r2 = t((3, 3, 64, 64), 0.04), t((3, 3, 64, 64), 0.04)
        res = t((6, h, w, 64))
        g = torch.from_numpy(rng.standard_normal((6, h, w, 64))
                             .astype(np.float32)).to(dev)
        cases = [
            ("pair 64->128->64 bias ns0.1", (x, w1, b1, w2, b2),
             lambda: fused_conv.conv3x3_pair(x, w1, b1, w2, b2, 0.1),
             lambda: pair_plain(x, w1, b1, w2, b2, 0.1)),
            ("pair 64->64->64 nobias ns0.2", (x, r1, r2),
             lambda: fused_conv.conv3x3_pair(x, r1, None, r2, None, 0.2),
             lambda: pair_plain(x, r1, None, r2, None, 0.2)),
            ("conv 64->64 +res", (x, r1, b2, res),
             lambda: fused_conv.conv3x3(x, r1, b2, res=res),
             lambda: fused_conv.conv3x3_plain(x, r1, b2, res=res)),
        ]
        for label, ins, kern, plain in cases:
            flips.clear()
            got = torch.autograd.grad(kern(), ins, g)
            ref = torch.autograd.grad(plain(), ins, g)
            torch.cuda.synchronize()
            errs = [float((a - r).abs().max()) for a, r in zip(got, ref)]
            tols = [CONV_RTOL * max(1.0, float(r.abs().max())) for r in ref]
            say("conv_grads", case=f"{label} 6x{h}x{w}", max_abs_err=errs,
                tol=tols, mask_flips=flips[0] if flips else None)
            if not all(e <= tol for e, tol in zip(errs, tols)):
                fail(f"conv gradients {label} {h}x{w}: {errs} > {tols}")


def phase_model(torch, dev):
    from fcvsr_tpu_torch.models import FCVSRNet, init_weights

    x = np.random.default_rng(1).uniform(0, 1, (1, 7, 1, 64, 96))
    x = x.astype(np.float32)
    for k_fused in (False, True):
        model = init_weights(FCVSRNet(in_channels=1, k_fused=k_fused),
                             torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            ref = model(torch.from_numpy(x)).numpy()
            model.to(dev)
            got = model(torch.from_numpy(x).to(dev)).cpu().numpy()
        err = float(np.abs(got - ref).max())
        say("model", model="FCVSR full Y", k_fused=k_fused,
            shape=list(got.shape), max_abs_err=err, tol=MODEL_ATOL)
        if got.shape != (1, 1, 256, 384) or not np.isfinite(got).all():
            fail(f"model output shape {got.shape} or non-finite values")
        if not err <= MODEL_ATOL:
            fail(f"GPU vs CPU model error {err} > {MODEL_ATOL}")

    # gradients: one Charbonnier-sum backward on each device
    from fcvsr_tpu_torch.train.losses import charbonnier_sum

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 7, 1, 32, 48))
                         .astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1, (1, 1, 128, 192))
                          .astype(np.float32))
    model = init_weights(FCVSRNet(in_channels=1),
                         torch.Generator().manual_seed(0))

    def grads(inp, device):
        model.zero_grad(set_to_none=True)
        model.to(device)
        charbonnier_sum(model(inp.to(device)), gt.to(device)).backward()
        return {k: None if p.grad is None else p.grad.cpu()
                for k, p in model.named_parameters()}

    def deviation(got, ref):
        """(whole, median, max) relative deviation, and the tensors over
        GRAD_RTOL."""
        rel, diff2, norm2 = {}, 0.0, 0.0
        for k, r in ref.items():
            g = got[k]
            if (r is None) != (g is None):
                fail(f"gradient of {k}: {r is not None} vs {g is not None}")
            if r is None:
                continue
            d = float((g - r).norm())
            diff2, norm2 = diff2 + d * d, norm2 + float(r.norm()) ** 2
            rel[k] = d / float(r.norm()) if r.any() else d
        over = {k: v for k, v in rel.items() if v > GRAD_RTOL}
        return ((diff2 / norm2) ** 0.5, float(np.median(list(rel.values()))),
                max(rel.values()), over)

    ref = grads(x, "cpu")
    moved = x * (1 + 1e-6 * torch.from_numpy(
        rng.standard_normal(x.shape).astype(np.float32)))
    floor = deviation(grads(moved, "cpu"), ref)
    whole, median, worst, over = deviation(grads(x, dev), ref)
    say("model_grads", model="FCVSR full Y", shape=[1, 7, 1, 32, 48],
        tensors=sum(g is not None for g in ref.values()),
        whole_rel_err=whole, median_rel_err=median,
        max_rel_err=worst, over_grad_rtol=over, grad_rtol=GRAD_RTOL,
        flip_rtol=FLIP_RTOL, cpu_floor_1e6=dict(
            whole=floor[0], median=floor[1], max=floor[2],
            n_over_grad_rtol=len(floor[3])))
    if not (whole <= GRAD_RTOL and median <= GRAD_RTOL
            and worst <= FLIP_RTOL):
        fail(f"GPU vs CPU gradients beyond the bounds: whole {whole}, "
             f"median {median}, over {over}")


def zoo_model(torch, name: str):
    """EDVR-M or BasicVSR++ at mmedit's published widths, seeded weights,
    every DCN's last offset conv drawn non-zero (it is zero-initialised,
    which would leave the DCN a plain conv): EDVR's offsets +-3 px about
    zero, BasicVSR++'s residues 10 * tanh(+-1.5) about the flows."""
    from fcvsr_tpu_torch.models import BACKBONES, build, init_weights
    from fcvsr_tpu_torch.models.basicvsr import ModulatedDeformConv2d

    model = init_weights(build(BACKBONES, dict(type=name)),
                         torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ModulatedDeformConv2d):
                last = [m for m in mod.conv_offset.modules()
                        if isinstance(m, torch.nn.Conv2d)][-1]
                last.weight.normal_(0, 0.3 / math.sqrt(last.weight[0].numel()),
                                    generator=gen)
                last.bias.normal_(0, 3.0 if name == "EDVRNet" else 1.5,
                                  generator=gen)
    return model


def phase_zoo_models(torch, dev):
    """EDVR-M and BasicVSR++, the GPU (the DCN kernel) against the same
    model on the CPU (the plain DCN), with the launches per forward."""
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts

    x = np.random.default_rng(5).uniform(0, 1, (1, 5, 3, 64, 96))
    x = torch.from_numpy(x.astype(np.float32))
    for name in ("EDVRNet", "BasicVSRPlusPlus"):
        model = zoo_model(torch, name)
        with torch.no_grad():
            ref = model(x)
            model.to(dev)
            reset_launch_counts()
            got = model(x.to(dev)).cpu()
            launches = launch_counts()["dcn"]
        err = float((got - ref).abs().max())
        say("model", model=name, shape=list(got.shape), max_abs_err=err,
            tol=MODEL_ATOL, dcn_launches=launches)
        if not (torch.isfinite(got).all() and got.shape == ref.shape):
            fail(f"{name}: output shape {got.shape} or non-finite values")
        if not err <= MODEL_ATOL:
            fail(f"{name}: GPU vs CPU model error {err} > {MODEL_ATOL}")
        if launches != dcn_per_forward(name, 5):
            fail(f"{name}: {launches} DCN launches a forward, expected "
                 f"{dcn_per_forward(name, 5)}")
        del model


def phase_zoo(torch, card):
    """Zoo serving: a synthetic 10-frame RGB clip restored through
    ``apis.restoration_video_inference`` by EDVR-M (5-frame windows) and
    BasicVSR++ (the whole clip), then ms per restored frame."""
    from fcvsr_tpu_torch import apis, cli
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts

    counts = {}
    for name, (h, w), window in (("EDVRNet", (180, 320), 5),
                                 ("BasicVSRPlusPlus", (192, 320), 0)):
        model = zoo_model(torch, name).to("cuda")
        rng = np.random.default_rng(6)
        # a smooth random clip: each frame a bilinear upsampling of a coarse
        # grid, drifting a little from frame to frame
        coarse = rng.uniform(0, 1, (1, 3, h // 8 + 1, w // 8 + 1))
        frames = []
        for i in range(ZOO_T):
            c = torch.nn.functional.interpolate(
                torch.from_numpy(np.roll(coarse, i, axis=-1)), size=(h, w),
                mode="bilinear", align_corners=False)
            frames.append(c[0].permute(1, 2, 0).numpy())
        frames = np.stack(frames).astype(np.float32)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        out = apis.restoration_video_inference(model, frames,
                                               window_size=window)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        forwards = ZOO_T if window else 1
        t = window or ZOO_T
        per_forward = counts[name]["dcn"] / forwards
        fps = cli.fps_benchmark(model, h, w, c=3, t=t,
                                frames_per_forward=1 if window else t,
                                n_iter=10 if window else 5)
        say("zoo", model=name, clip=[ZOO_T, h, w, 3], window=window,
            out_shape=list(out.shape), forwards=forwards,
            dcn_launches_per_forward=per_forward, launches=counts[name],
            max_memory_allocated=peak, card=card, **fps)
        if out.shape != (ZOO_T, 4 * h, 4 * w, 3) or not np.isfinite(out).all():
            fail(f"{name}: output {out.shape} or non-finite values")
        if per_forward != dcn_per_forward(name, t):
            fail(f"{name}: {per_forward} DCN launches a forward, expected "
                 f"{dcn_per_forward(name, t)}")
        if any(v for k, v in counts[name].items() if k != "dcn"):
            fail(f"{name}: FCVSR kernels launched on the zoo path "
                 f"{counts[name]}")
        if not fps["ms_per_frame"] > 0:
            fail(f"{name}: bad timing {fps}")
        del model
    return {k: sum(c[k] for c in counts.values()) for k in counts["EDVRNet"]}


def write_clip(root: str, n: int = 10, h: int = 270, w: int = 480):
    """A smooth random Y clip: GT at 4x, LR its 4x4 block mean."""
    from PIL import Image

    rng = np.random.default_rng(2)
    base = rng.uniform(0, 255, (n + 3, h // 6 + 2, w // 6 + 2))
    for i in range(n):
        coarse = base[i:i + 4].mean(0)
        gt = np.kron(coarse, np.ones((24, 24)))[: 4 * h, : 4 * w]
        gt = np.clip(gt + rng.normal(0, 4, gt.shape), 0, 255)
        lr = gt.reshape(h, 4, w, 4).mean((1, 3))
        for sub, img in (("lr", lr), ("gt", gt)):
            d = os.path.join(root, sub, "clip")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(d, f"{i:08d}.png"))


def phase_slice(torch, card):
    from PIL import Image

    from fcvsr_tpu_torch import cli
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts

    with tempfile.TemporaryDirectory() as tmp:
        write_clip(tmp)
        out_dir = os.path.join(tmp, "sr")
        reset_launch_counts()
        summary = cli.main(["--preset", PRESET, "--seed", "0",
                            "--lr-root", os.path.join(tmp, "lr"),
                            "--gt-root", os.path.join(tmp, "gt"),
                            "--save-dir", out_dir])
        counts = launch_counts()
        r = summary["per_sequence"]["clip"]
        sr = np.asarray(Image.open(os.path.join(out_dir, "clip",
                                                "00000000.png")))
    per_frame = {k: v / r["forwards"] for k, v in counts.items()}
    say("slice", preset=PRESET, frames=r["frames"], forwards=r["forwards"],
        psnr=r["psnr"], ssim=r["ssim"], ms_per_frame=r["ms_per_frame"],
        sr_shape=list(sr.shape), launches=counts,
        launches_per_frame=per_frame, card=card)
    if r["frames"] != 10 or sr.shape != (1080, 1920):
        fail(f"expected 10 frames cropped to 1080x1920, got {r['frames']} "
             f"and {sr.shape}")
    if not (math.isfinite(r["psnr"]) and math.isfinite(r["ssim"])):
        fail(f"non-finite PSNR/SSIM {r['psnr']} {r['ssim']}")
    if per_frame != {k: float(v) for k, v in PER_FRAME.items()}:
        fail(f"launches per frame {per_frame}, expected {PER_FRAME}")
    fps = cli.main(["--preset", PRESET, "--seed", "0", "--fps"])
    say("fps", preset=PRESET, shape=[1, 7, 1, 272, 480], card=card, **fps)
    if not fps["ms_per_frame"] > 0:
        fail(f"bad FPS result {fps}")
    return counts


def phase_train(torch, card):
    """The training slice: one warm-up step, then a resumed run of 5 timed
    steps, with the launch counts of all 6 steps."""
    from fcvsr_tpu_torch.ops import launch_counts, reset_launch_counts
    from fcvsr_tpu_torch.train import cli as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        write_clip(tmp)
        args = ["--preset", PRESET, "--seed", "0",
                "--lr-root", os.path.join(tmp, "lr"),
                "--gt-root", os.path.join(tmp, "gt"),
                "--work-dir", os.path.join(tmp, "work")]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        warm = train_cli.main(args + ["--total-iters", "1"])
        timed = train_cli.main(args + ["--total-iters", "6"])
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
    steps = warm["step"] + timed["step"] - timed["start"]
    per_step = {k: v / steps for k, v in counts.items()}
    losses = warm["losses"] + timed["losses"]
    ms = timed["ms_per_step"]
    say("train", preset=PRESET, batch=6, lr_patch=128, steps=steps,
        resumed_at=timed["start"], losses=losses,
        warmup_ms=warm["ms_per_step"][0], ms_per_step=ms,
        ms_median=float(np.median(ms)), ms_min=min(ms), ms_max=max(ms),
        max_memory_allocated=peak, launches=counts,
        launches_per_step=per_step, card=card)
    if timed["start"] != 1 or timed["step"] != 6 or steps != 6:
        fail(f"resume: started at {timed['start']}, ended at {timed['step']}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss {losses}")
    if per_step != {k: float(v) for k, v in PER_STEP.items()}:
        fail(f"launches per step {per_step}, expected {PER_STEP}")
    return counts


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA GPU")
    if not os.path.isdir(os.path.join(HERE, "fcvsr_tpu_torch")):
        fail(f"no fcvsr_tpu_torch package beside {__file__}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = nvidia_smi()
    print(card, flush=True)
    from fcvsr_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.lib()
    say("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        build_s=_native.build_seconds, load_s=time.perf_counter() - t0)

    results = phase_kernels(torch, dev)
    torch.cuda.empty_cache()
    phase_conv_grads(torch, dev)
    torch.cuda.empty_cache()
    phase_model(torch, dev)
    torch.cuda.empty_cache()
    phase_zoo_models(torch, dev)
    torch.cuda.empty_cache()
    phase_slice(torch, card)
    zoo_counts = phase_zoo(torch, card)
    torch.cuda.empty_cache()
    train_counts = phase_train(torch, card)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path, counts = ("zoo serving", zoo_counts) if name == "dcn" \
            else ("training", train_counts)
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the {path} path")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counts[name],
                            **results[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
