#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``fcvsr_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line or more each:
  1. device and build: the card's name and power limit (nvidia-smi), torch
     and CUDA versions, the nvcc build of ``fcvsr_tpu_torch/csrc``;
  2. every kernel of the serving path against its plain PyTorch version on
     the card, at the shapes FCVSR gives it, with the max abs error against
     the stated tolerance and both CUDA-event times (median of 7 after 2
     warm-ups, the two versions timed in turns);
  3. model parity: FCVSR full, Y, seeded weights, (1, 7, 1, 64, 96), the
     GPU (kernels) against the same model on the CPU (plain versions);
  4. the slice: ``fcvsr_tpu_torch.cli`` evaluates a synthetic 10-frame
     480x270 clip on preset fcvsr_cvcpLD_QP22 (270 -> 272 pad, output crop,
     PSNR / SSIM), with the kernel launch counts per frame checked, then
     ``--fps`` at 1 x 7 x 1 x 272 x 480;
  5. a JSON line of the kernels, the nvidia-smi line, and the result line.

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
PER_FRAME = {"iac": 36, "conv3x3_pair": 180, "conv3x3": 31}
KERNELS = {
    "iac": ("fcvsr_tpu_torch/csrc/iac.cu", "fcvsr_tpu/ops/pallas_iac.py:98"),
    "conv3x3_pair": ("fcvsr_tpu_torch/csrc/conv3x3.cu",
                     "fcvsr_tpu/ops/pallas_conv.py:236"),
    "conv3x3": ("fcvsr_tpu_torch/csrc/conv3x3.cu",
                "fcvsr_tpu/ops/pallas_conv.py:108"),
}
# f32 kernels against f32 plain versions that sum in another order: the
# bound scales with the output's magnitude (IAC: 3x3 taps of a warped value
# and a 64-term kernel dot in kf mode; convs: up to 1152-term dot products)
IAC_RTOL = 2e-5
CONV_RTOL = 1e-4
# GPU vs CPU model output in [0, 1]: well under one 8-bit grey level (3.9e-3)
MODEL_ATOL = 1e-3


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


def phase_kernels(torch, dev):
    from fcvsr_tpu_torch.ops import fused_conv, fused_iac

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    results = {name: {"max_abs_err": 0.0} for name in KERNELS}

    def check(name, label, kern, plain, rtol, timed=False):
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = rtol * max(1.0, float(ref.abs().max()))
        line = dict(kernel=name, case=label, max_abs_err=err, tol=tol)
        if timed:
            ms, plain_ms = cuda_ms(torch, [kern, plain])
            line.update(ms=ms, plain_ms=plain_ms)
            if "ms" not in results[name]:
                results[name].update(ms=ms, plain_ms=plain_ms)
        say("kernels", **line)
        if not err <= tol:
            fail(f"{name} {label}: max abs error {err} > {tol}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    # IAC at the FCVSR shape: B=1, C=64, 272x480, 6 iterations of kernels;
    # flows mix small, +-20 px and out-of-frame displacements
    b, h, w, c, n_it = 1, 272, 480, 64, 6
    feat = t(rng.standard_normal((b, h, w, c)))
    fin = t(rng.standard_normal((b, h, w, c)))
    flow = rng.standard_normal((b, h, w, 2)) * 1.5
    flow[:, : h // 3] = rng.uniform(-20, 20, (b, h // 3, w, 2))
    flow[:, -h // 6 :, :, 0] += 600.0
    flow[:, :, : w // 8, 1] -= 400.0
    flow = t(flow)
    k = t(rng.standard_normal((b, h, w, n_it * 3 * c)) * 0.3)
    f0 = t(rng.standard_normal((b, h, w, c)))
    wsel = t(rng.standard_normal((c, n_it * 3 * c)) * 0.1)
    bsel = t(rng.standard_normal((n_it * 3 * c,)) * 0.1)
    # the materialised-kernel variant first: it is the one the slice serves,
    # so its times are the ones the result line reports
    for it, act in ((0, True), (5, False)):
        check("iac", f"materialised it={it} act={act} 272x480x64",
              lambda: fused_iac.warp_sac_fused(feat, flow, k, fin, act, it),
              lambda: fused_iac.warp_sac_plain(feat, flow, k, fin, act, it),
              IAC_RTOL, timed=it == 0)
        check("iac", f"kf it={it} act={act} 272x480x64",
              lambda: fused_iac.warp_sac_fused_kf(feat, flow, f0, wsel, bsel,
                                                  fin, act, it),
              lambda: fused_iac.warp_sac_plain(
                  feat, flow, fused_iac.predict_kernels(f0, wsel, bsel, it, c),
                  fin, act),
              IAC_RTOL, timed=it == 0)
    del feat, fin, flow, k, f0

    # SCNet convs at its three levels
    for (h, w) in ((272, 480), (136, 240), (68, 120)):
        x = t(rng.standard_normal((1, h, w, 64)))
        w1 = t(rng.standard_normal((3, 3, 64, 128)) * 0.04)
        b1 = t(rng.standard_normal(128) * 0.1)
        w2 = t(rng.standard_normal((3, 3, 128, 64)) * 0.03)
        b2 = t(rng.standard_normal(64) * 0.1)
        check("conv3x3_pair", f"64->128->64 bias ns0.1 {h}x{w}",
              lambda: fused_conv.conv3x3_pair(x, w1, b1, w2, b2, 0.1),
              lambda: fused_conv.conv3x3_pair_plain(x, w1, b1, w2, b2, 0.1),
              CONV_RTOL, timed=h == 272)
        r1 = t(rng.standard_normal((3, 3, 64, 64)) * 0.04)
        r2 = t(rng.standard_normal((3, 3, 64, 64)) * 0.04)
        check("conv3x3_pair", f"64->64->64 nobias ns0.2 {h}x{w}",
              lambda: fused_conv.conv3x3_pair(x, r1, None, r2, None, 0.2),
              lambda: fused_conv.conv3x3_pair_plain(x, r1, None, r2, None,
                                                    0.2),
              CONV_RTOL, timed=h == 272)
        res = t(rng.standard_normal((1, h, w, 64)))
        check("conv3x3", f"64->64 +res {h}x{w}",
              lambda: fused_conv.conv3x3(x, r1, b2, res=res),
              lambda: fused_conv.conv3x3_plain(x, r1, b2, res=res),
              CONV_RTOL, timed=h == 272)
    x = t(rng.uniform(-1, 1, (1, 1088, 1920, 64)))
    wl = t(rng.standard_normal((3, 3, 64, 1)) * 0.04)
    bl = t(rng.standard_normal(1))
    check("conv3x3", "64->1 conv_last0 1088x1920",
          lambda: fused_conv.conv3x3(x, wl, bl),
          lambda: fused_conv.conv3x3_plain(x, wl, bl), CONV_RTOL, timed=True)
    return results


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
    phase_model(torch, dev)
    torch.cuda.empty_cache()
    counts = phase_slice(torch, card)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if counts[name] == 0:
            fail(f"kernel {name} was not launched on the main path")
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
