"""Probe the card and the kernel toolchain: does a matrix product run on the
card, does cuDNN's bf16 conv pay, and do nvcc for sm_90a and ctypes loading
work on this machine?

    python -m fcvsr_tpu_torch.tools.gpu_probe [--skip-kernel] [--out PATH]

Counterpart of the JAX package's ``tools/tpu_probe.py``, with the same three
probes, each in its own subprocess with a timeout, so that a hung CUDA
runtime or compiler cannot take the caller down:

  dot        a 256x256 float32 ``torch.matmul`` of ones on the card, checked
             (every entry is 256), and its seconds, CUDA start-up included;
  bf16_conv  cuDNN's 3x3 64->64 conv at 1x64x272x480, float32 (TF32 off)
             against bf16: the median CUDA-event ms of each and bf16 over
             float32.  A library call on purpose: it probes the card, not a
             kernel of the port;
  kernel     the toolchain (K12): nvcc builds ``csrc/probe/scale2.cu``
             alone for sm_90a into ``_build/probe/``, ctypes loads it, and
             o = 2 x on an (8, 128) float32 tensor is checked exactly; the
             nvcc version, the build's seconds, the launches of the check
             and the median CUDA-event time of one launch.

The JSON goes to ``--out`` (default ``fcvsr_tpu_torch/_build/gpu_probe.json``)
and is printed.  After a failed dot probe the others are skipped.  The exit
code is 1 when a probe that ran failed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..ops import _native
from ..profiling import cuda_ms

__all__ = ["scale2", "scale2_plain", "probe_lib", "main"]

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "csrc" / "probe" / "scale2.cu"
DEFAULT_OUT = _native.BUILD_DIR / "gpu_probe.json"
TIMEOUTS = {"dot": 300, "bf16_conv": 300, "kernel": 600}


def probe_lib():
    """(the probe's library, its build seconds or None when it was built
    already): ``scale2.cu`` built alone by ``_native.side_lib`` into
    ``_build/probe/``."""
    return _native.side_lib(
        "probe", [SOURCE],
        {"fcvsr_probe_scale2": [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_void_p]},
        "fcvsr_probe_error_string")


def scale2_plain(x):
    return x * 2.0


def scale2(x):
    """o = 2 x: the probe kernel on a contiguous float32 CUDA tensor, its
    plain version on a CPU tensor.  ``scale2.launches`` counts launches."""
    if _native.on_cpu(x):
        return scale2_plain(x)
    _native.require(x, "x", x.device)
    out = torch.empty_like(x)
    lib, _ = probe_lib()
    with _native.launch_guard(x) as stream:
        rc = lib.fcvsr_probe_scale2(x.data_ptr(), out.data_ptr(), x.numel(),
                                    stream)
    _native.check_side(lib, rc, "scale2")
    scale2.launches += 1
    return out


scale2.launches = 0


def _need_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA "
                           "device")


def probe_dot() -> dict:
    t0 = time.perf_counter()
    _need_cuda()
    a = torch.ones((256, 256), device="cuda")
    v = torch.matmul(a, a)
    ok = bool((v == 256).all())
    return {"value": float(v[0, 0]), "secs": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(0), "check": ok}


def probe_bf16_conv() -> dict:
    _need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 64, 272, 480), generator=g).cuda()
    w = (torch.randn((64, 64, 3, 3), generator=g) * 0.01).cuda()
    conv = torch.nn.functional.conv2d
    ms = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xd, wd = x.to(dt), w.to(dt)
        ms[name] = cuda_ms([lambda: conv(xd, wd, padding=1)], 21, 3)[0]
    return {"f32_ms": ms["f32"], "bf16_ms": ms["bf16"],
            "bf16_over_f32": ms["bf16"] / ms["f32"], "check": True}


def probe_kernel() -> dict:
    _need_cuda()
    lib, build_s = probe_lib()
    nvcc = subprocess.run([_native._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda").reshape(8,
                                                                         128)
    scale2.launches = 0
    o = scale2(x)
    torch.cuda.synchronize()
    launches = scale2.launches
    ok = bool(torch.equal(o, scale2_plain(x)))
    return {"nvcc": nvcc[-1], "build_s": build_s, "launches": launches,
            "launch_ms": cuda_ms([lambda: scale2(x)], 21, 3)[0], "check": ok}


PROBES = {"dot": probe_dot, "bf16_conv": probe_bf16_conv,
          "kernel": probe_kernel}


def _run(name: str) -> dict:
    """Run one probe in a subprocess with its timeout: its result with
    ``ok`` and the subprocess's ``wall_s``; on a failure also the error."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG.parent)] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "fcvsr_tpu_torch.tools.gpu_probe",
             "--probe", name], capture_output=True, text=True, env=env,
            cwd=str(PKG.parent), timeout=TIMEOUTS[name])
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"timeout {TIMEOUTS[name]}s",
                "wall_s": time.perf_counter() - t0}
    out = {"ok": False, "wall_s": time.perf_counter() - t0}
    for line in proc.stdout.splitlines():
        if line.startswith("PROBE_OK "):
            out.update(json.loads(line[len("PROBE_OK "):]))
            out["ok"] = bool(out.pop("check"))
            if not out["ok"]:
                out["error"] = "the result differs from its known value"
    if "error" not in out and not out["ok"]:
        tail = proc.stderr.strip().splitlines() or [
            f"exit code {proc.returncode}, no result"]
        out["error"] = tail[-1][:300]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-kernel", action="store_true",
                    help="skip the nvcc build and launch of the probe kernel")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--probe", choices=sorted(PROBES), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.probe:  # one probe, in the subprocess that _run started
        print("PROBE_OK " + json.dumps(PROBES[args.probe]()), flush=True)
        return 0

    results = {"when": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    results["dot"] = _run("dot")
    ran = ["dot"]
    if results["dot"]["ok"]:
        results["bf16_conv"] = _run("bf16_conv")
        ran.append("bf16_conv")
    else:
        results["bf16_conv"] = {"ok": False,
                                "error": "skipped: the dot probe failed"}
    if args.skip_kernel:
        results["kernel"] = {"ok": False, "error": "skipped by flag"}
    elif results["dot"]["ok"]:
        results["kernel"] = _run("kernel")
        ran.append("kernel")
    else:
        results["kernel"] = {"ok": False,
                             "error": "skipped: the dot probe failed"}
    results["ok"] = all(results[name]["ok"] for name in ran)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
