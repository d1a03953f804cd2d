"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source in ``csrc/`` at first use, one process a
source, all started together, and links the objects into one shared library
under ``fcvsr_tpu_torch/_build/``; the file name carries a hash of the
sources and flags, so an edit rebuilds and an unchanged tree loads the
library it already built.  The library has a plain C interface, bound here
with ``ctypes``: each entry point takes device pointers, sizes and a CUDA
stream, launches on that stream and returns ``cudaGetLastError()``.

There is no fallback: without ``nvcc`` or a CUDA device, :func:`lib` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["lib", "check", "ptr", "require", "records", "on_cpu",
           "stream_ptr", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # feat, flow, k|wsel, k_ld, k_off, f0, bsel, c0, feat_in, out,
    # B, H, W, C, act, stream
    "fcvsr_iac_step": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P,
                       _I, _I, _I, _I, _I, _P],
    # src, flow, k, k_ld, k_off, gz, dk, dwarped, B, H, W, C, stream
    "fcvsr_iac_bwd_sac": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    # src, flow, dwarped, dsrc, dflow, B, H, W, C, stream
    "fcvsr_iac_bwd_warp": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w, bias, res, out, B, H, W, Cin, Cout, act, ns, stream
    "fcvsr_conv3x3": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # x, w1, b1, w2, b2, out, B, H, W, Cin, C1, Cout, ns1, stream
    "fcvsr_conv3x3_pair": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _F, _P],
    # x, offset, mask, w, bias, out, B, H, W, Cin, Cout, dg, stream
    "fcvsr_dcn3x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process, or None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "fcvsr_tpu_torch: nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
        "the CUDA kernels are built from csrc/ with nvcc at first use")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _raise_if_failed(cmd, rc: int, out: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fcvsr_tpu_torch: nvcc failed ({rc}):\n"
                           f"{' '.join(cmd)}\n{out}")


def _build() -> Path:
    global build_seconds
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    target = BUILD_DIR / f"libfcvsr_kernels_{digest.hexdigest()[:16]}.so"
    if target.is_file():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, jobs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            objs.append(os.path.join(tmp, src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", objs[-1]]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compile before raising on any
        logs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in jobs]
        for cmd, out, rc in logs:
            _raise_if_failed(cmd, rc, out)
        lib_tmp = os.path.join(tmp, target.name)
        link = [nvcc, "-shared", "-o", lib_tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        _raise_if_failed(link, proc.returncode, proc.stdout + proc.stderr)
        os.replace(lib_tmp, target)
    build_seconds = time.perf_counter() - t0
    return target


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "fcvsr_tpu_torch: the CUDA kernels need a CUDA device; "
                    "torch.cuda.is_available() is False")
            handle = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.fcvsr_error_string.argtypes = [ctypes.c_int]
            handle.fcvsr_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = _lib.fcvsr_error_string(rc).decode()
        raise RuntimeError(f"fcvsr_tpu_torch: {what} launch failed: "
                           f"CUDA error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for a missing operand."""
    return None if t is None else t.data_ptr()


def require(t, name: str, device: torch.device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor on ``device`` with
    ``shape``, and carries no autograd history the launch would drop."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{name} requires grad: a kernel launch records no autograd "
            "history; train through fused_iac.iac_fused and "
            "fused_conv.conv3x3[_pair], which route to their autograd "
            "Functions, or run under torch.no_grad()")


def records(*tensors) -> bool:
    """True when autograd records an op on ``tensors`` (None entries
    skipped): grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def on_cpu(t) -> bool:
    """True when the plain version applies (``t`` is on the CPU); any device
    other than the CPU or CUDA raises."""
    dev = t.device
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: CPU or CUDA")
    return False
