"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source in ``csrc/`` at first use, one process a
source, all started together, and links the objects into one shared library
under ``fcvsr_tpu_torch/_build/``; the file name carries a hash of the
sources and flags, so an edit rebuilds and an unchanged tree loads the
library it already built.  The library has a plain C interface, bound here
with ``ctypes``: each entry point takes device pointers, sizes and a CUDA
stream, launches on that stream and returns ``cudaGetLastError()``.

Kernels off the model paths (the toolchain probe, the microbenchmarks)
live in their own libraries, built the same way from their own sources into
``_build/<name>/`` by :func:`side_lib`: the main library's glob takes only
``csrc/*.cu``, so a fault in one of those sources cannot break it.

There is no fallback: without ``nvcc`` or a CUDA device, :func:`lib` raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["lib", "check", "side_lib", "check_side", "lib_path",
           "csrc_headers", "ptr", "require", "records", "on_cpu", "sass_ops",
           "edited_sources", "build_variants", "launch_guard", "storage",
           "traced", "real_tensors", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # feat, flow, k|wsel, k_ld, k_off, f0, bsel, c0, feat_in, out,
    # B, H, W, C, act, bf16, stream
    "fcvsr_iac_step": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _P,
                       _I, _I, _I, _I, _I, _I, _P],
    # feat_in, flows, k, scratch, out, counters, B, H, W, C, ac, act_last,
    # bf16, stream
    "fcvsr_iac_chain": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _P],
    # src, flow, k, k_ld, k_off, gz, dk, dsrc, dflow, B, H, W, C, stream
    "fcvsr_iac_bwd": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                      _P],
    # x, w, bias, res, out, B, H, W, Cin, Cout, act, ns, bf16, stream
    "fcvsr_conv3x3": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                      _P],
    # x, w1, b1, w2, b2, out, B, H, W, Cin, C1, Cout, ns1, bf16, stream
    "fcvsr_conv3x3_pair": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _F, _I, _P],
    # x, w1, b1, w2, b2, w3, b3, w4, b4, y, out, B, H, W, C, C1, C2, C3,
    # Cout, ns1, ns3, bf16, stream
    "fcvsr_conv3x3_quad": [_P] * 11 + [_I] * 8 + [_F, _F, _I, _P],
    # x, wb0, bb0, wb1, bb1, wr0, wr1, wmask, a0, a1, y, r, out, part,
    # part_blocks, B, H, W, C, C1, ns_body, stream
    "fcvsr_blockrcb": [_P] * 14 + [_I] * 6 + [_F, _P],
    # B, H, W, C, C1, int* grid
    "fcvsr_blockrcb_grid": [_I] * 5 + [ctypes.POINTER(_I)],
    # x, offset, mask, w, bias, out, B, H, W, Cin, Cout, dg, stream
    "fcvsr_dcn3x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, offset, mask, w, g, dx, doffset, dmask, dw, dbias, B, H, W, Cin,
    # Cout, dg, zeroed, stream
    "fcvsr_dcn3x3_bwd": [_P] * 10 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib = None
_build_error = None  # a failed build, raised again without rebuilding
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


def _raise_if_failed(cmd, rc: int, out: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fcvsr_tpu_torch: nvcc failed ({rc}):\n"
                           f"{' '.join(cmd)}\n{out}")


def lib_path(name: str, sources, build_dir: Path, headers=()) -> Path:
    """``build_dir / lib<name>_<hash>.so``: the hash covers the flags and
    the names and bytes of ``sources`` and ``headers``, so an edit to any of
    them names another library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *headers]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return build_dir / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _build_lib(name: str, sources, build_dir: Path, headers=()):
    """(path of the shared library :func:`lib_path` names, the build's wall
    seconds or None when it was built already).  nvcc compiles each source
    in its own process, all started together, then links the objects."""
    target = lib_path(name, sources, build_dir, headers)
    if target.is_file():
        return target, None
    nvcc = _nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs, jobs = [], []
        for src in sources:
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
    return target, time.perf_counter() - t0


def _build() -> Path:
    global build_seconds
    target, seconds = _build_lib("fcvsr_kernels", sorted(CSRC.glob("*.cu")),
                                 BUILD_DIR, csrc_headers())
    if seconds is not None:
        build_seconds = seconds
    return target


def csrc_headers() -> list:
    """The headers every library's hash covers: ``csrc/*.cuh``."""
    return sorted(CSRC.glob("*.cuh"))


_side_libs = {}


def side_lib(name: str, sources, signatures: dict, error_string: str):
    """(a library of its own, its build seconds or None): ``sources`` (and
    the headers of ``csrc/``, which they may include: ``common.cuh``,
    ``hopper.cuh``, ...) built by :func:`_build_lib` into
    ``_build/<name>/``, apart from the model's library, so that a fault in
    one cannot break the other.  ``signatures`` maps each entry point to
    its argtypes (each returns a CUDA error code); ``error_string`` names
    the library's ``cudaGetErrorString``, kept as ``lib.error_string``.
    Built once a process; a failed build raises again on every call.  A
    built library is served without the lock."""
    got = _side_libs.get(name)
    if got is None:
        got = _load_side(name, sources, signatures, error_string)
    if isinstance(got, Exception):
        raise got
    return got


def _load_side(name, sources, signatures, error_string):
    with _lock:
        if name not in _side_libs:
            try:
                path, seconds = _build_lib(name, sorted(sources),
                                           BUILD_DIR / name, csrc_headers())
                handle = ctypes.CDLL(str(path))
                for fn, argtypes in signatures.items():
                    getattr(handle, fn).argtypes = argtypes
                    getattr(handle, fn).restype = ctypes.c_int
                handle.error_string = getattr(handle, error_string)
                handle.error_string.argtypes = [ctypes.c_int]
                handle.error_string.restype = ctypes.c_char_p
                _side_libs[name] = (handle, seconds)
            except (RuntimeError, OSError) as err:
                _side_libs[name] = err
        return _side_libs[name]


def edited_sources(source: str, edits) -> dict:
    """{path under csrc/: text} of ``source`` (a path under ``csrc/``) and
    every ``csrc/*.cuh`` with ``edits`` applied: ``[old, new]`` replaces
    text of ``source``, ``[file, old, new]`` of that file; an edit whose old
    text is missing raises ValueError.  ``edits`` given as a directory's
    path takes the files it has (another version of the kernel) in place
    of the tree's; ``{"dir": path, "edits": [...]}`` edits those."""
    names = [source, *(h.name for h in csrc_headers())]
    root = CSRC
    if isinstance(edits, str):
        edits = {"dir": edits, "edits": []}
    if isinstance(edits, dict):
        root, edits = Path(edits["dir"]), edits["edits"]
        names += [p.name for p in root.glob("*.cuh") if p.name not in names]
    texts = {n: ((root / n) if (root / n).is_file() else CSRC / n).read_text()
             for n in names}
    for edit in edits:
        name, old, new = edit if len(edit) == 3 else (source, *edit)
        if old not in texts[name]:
            raise ValueError(f"{name} has no {old!r}")
        texts[name] = texts[name].replace(old, new)
    return texts


def build_variants(tool: str, source: str, variants: dict, entry: str,
                   argtypes, flags=()) -> dict:
    """{name: (``entry`` of the variant's library, nvcc's output)}: each
    variant (``name: edits``, see :func:`edited_sources`) written to
    ``_build/<tool>/<name>/`` and built alone by nvcc (``flags`` added),
    all at once, for the A/B scripts of ``benchmarks/``; with ``entry``
    None, the library itself in its place.  A failed build raises with
    nvcc's output."""
    jobs = {}
    for name, edits in variants.items():
        root = BUILD_DIR / tool / name
        shutil.rmtree(root, ignore_errors=True)
        for fname, text in edited_sources(source, edits).items():
            (root / fname).parent.mkdir(parents=True, exist_ok=True)
            (root / fname).write_text(text)
        lib = root / "lib.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-shared", str(root / source),
               "-o", str(lib)]
        jobs[name] = (lib, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, cmd, proc) in jobs.items():
        out = proc.communicate()[0]
        _raise_if_failed(cmd, proc.returncode, out)
        handle = ctypes.CDLL(str(lib))
        if entry is None:
            built[name] = (handle, out)
            continue
        fn = getattr(handle, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        built[name] = (fn, out)
    return built


def check_side(lib, rc: int, what: str) -> None:
    """Raise if a launch from a :func:`side_lib` library returned a CUDA
    error code."""
    if rc != 0:
        raise RuntimeError(f"fcvsr_tpu_torch: {what} launch failed: CUDA "
                           f"error {rc} ({lib.error_string(rc).decode()})")


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call; once loaded, served without
    the lock (every launch asks for it)."""
    handle = _lib
    if handle is not None:
        return handle
    return _load()


def _load() -> ctypes.CDLL:
    global _lib, _build_error
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "fcvsr_tpu_torch: the CUDA kernels need a CUDA device; "
                    "torch.cuda.is_available() is False")
            if _build_error is not None:
                raise _build_error
            try:
                path = _build()
            except RuntimeError as err:
                _build_error = err
                raise
            handle = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.fcvsr_error_string.argtypes = [ctypes.c_int]
            handle.fcvsr_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def sass_ops(path, kernel: str, ops) -> dict | None:
    """{function: {op: count}} for every function whose (mangled) name
    holds ``kernel`` in ``cuobjdump -sass`` of the library at ``path``: the
    lines that hold each SASS op of ``ops`` (HGMMA is wgmma, UTMALDG a TMA
    tensor load, HMMA mma.sync, LDSM ldmatrix, FFMA a float32 FMA).  None
    when the toolkit has no cuobjdump."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or str(Path(home) / "bin" / "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = _sass_dump(tool, str(path))
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if kernel in name else None
            if name:
                counts[name] = dict.fromkeys(ops, 0)
        elif name:
            for op in ops:
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


@functools.lru_cache(maxsize=None)
def _sass_dump(tool: str, path: str) -> str:
    """``tool -sass path``, made once a library: a library's name holds
    its sources' hash (:func:`lib_path`), so the dump cannot go stale."""
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = _lib.fcvsr_error_string(rc).decode()
        raise RuntimeError(f"fcvsr_tpu_torch: {what} launch failed: "
                           f"CUDA error {rc} ({msg})")


class launch_guard:
    """``with launch_guard(t) as stream``: ``t``'s device is the current one
    for the launch, and ``stream`` its current stream (a handle for the C
    side).  The C side launches on the current device and asks it for its
    attributes (shared memory, occupancy), so a launch outside this guard
    would run on another card than its tensors.  The device is switched,
    and switched back, only when another one is current: each wrapper
    enters the guard on every launch."""

    __slots__ = ("_index", "_prev")

    def __init__(self, t):
        self._index = t.device.index

    def __enter__(self) -> int:
        prev = torch.cuda.current_device()
        self._prev = None if prev == self._index else prev
        if self._prev is not None:
            torch.cuda.set_device(self._index)
        return torch.cuda.current_stream(self._index).cuda_stream

    def __exit__(self, *exc) -> None:
        if self._prev is not None:
            torch.cuda.set_device(self._prev)


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for a missing operand."""
    return None if t is None else t.data_ptr()


def require(t, name: str, device: torch.device, shape=None,
            dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    with ``shape``, and carries no autograd history the launch would
    drop."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{name} requires grad: a kernel launch records no autograd "
            "history; train through fused_iac.iac_fused, "
            "fused_conv.conv3x3[_pair] and "
            "fused_dcn.modulated_deform_conv2d_fused, which route to their "
            "autograd Functions, or run under torch.no_grad()")


def weights_f32(*ts):
    """The kernels' weights and biases in float32: a bf16 one (the whole
    model in bf16, ``utils.precision``) cast up, which is exact; None and
    the others as they are."""
    return tuple(t.float() if t is not None and t.dtype == torch.bfloat16
                 else t for t in ts)


def storage(t) -> int:
    """The kernels' storage flag of a map: 0 for float32, 1 for bfloat16;
    any other type raises."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the kernels store maps as float32 or bfloat16, not "
                    f"{t.dtype}")


def records(*tensors) -> bool:
    """True when autograd records an op on ``tensors`` (None entries
    skipped): grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def traced(t) -> bool:
    """True while ``torch.export`` (or ``torch.compile``) traces a forward:
    ``t`` is then a fake tensor, with no storage, data pointer or version
    of its own, and a cache keyed on those (a weight prepared once a
    weight version) must be neither read, which would freeze a real tensor
    into the graph, nor filled, which would keep the fake one."""
    return torch.compiler.is_compiling() or \
        isinstance(t, torch._subclasses.FakeTensor)


def real_tensors(t):
    """A context in which ops run eagerly on real tensors even while
    ``torch.export`` traces (its fake and tracing modes suspended, when
    :func:`traced` holds for ``t``; else it does nothing): for the tables
    an op makes once for a shape and caches (``ops.freq``'s band masks,
    ``ops.corr``'s lookup indices).  Made under the tracer they would be
    fake, and the cache would hand them to every later eager call, and the
    graph would make them again on every call; made real, the graph takes
    them as constants."""
    if not traced(t):
        return contextlib.nullcontext()
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


def on_cpu(t) -> bool:
    """True when the plain version applies (``t`` is on the CPU); any device
    other than the CPU or CUDA raises."""
    dev = t.device
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: CPU or CUDA")
    return False
