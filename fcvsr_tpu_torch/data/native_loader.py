"""ctypes bindings of the port's threaded PNG decoder,
``csrc/host/loader.cpp`` (counterpart of ``fcvsr_tpu.data.native_loader``).

The decoder replaces per-frame PIL decoding where whole datasets of PNGs
are read (the reference preloads them at startup).  ``g++`` builds it at
first use into ``_build/host/libfcvsr_loader_<hash>.so``: the hash covers
the flags and the source, so an edit rebuilds and an unchanged tree loads
the library it built.  A failed build is kept and raised again by
:func:`load_library` without rebuilding.

The decoding functions keep the JAX package's API: without the library
they decode with PIL.  :func:`native_available` says whether the library
loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List

import numpy as np

__all__ = ["native_available", "load_library", "load_image_native",
           "load_batch_native", "u8_to_f32_native"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "loader.cpp"
BUILD_DIR = _PKG / "_build" / "host"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LINK = ("-lz", "-lpthread")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # path, width, height, channels
    "fcvsr_png_info": ([ctypes.c_char_p, _IP, _IP, _IP], ctypes.c_int),
    # path, out, out_channels, width, height
    "fcvsr_png_decode": ([ctypes.c_char_p, _U8P, ctypes.c_int, _IP, _IP],
                         ctypes.c_int),
    # paths, n, out, out_channels, frame_h, frame_w, num_threads
    "fcvsr_png_decode_batch": ([ctypes.POINTER(ctypes.c_char_p),
                                ctypes.c_int, _U8P] + [ctypes.c_int] * 4,
                               ctypes.c_int),
    # in, out, n
    "fcvsr_u8_to_f32": ([_U8P, ctypes.POINTER(ctypes.c_float),
                         ctypes.c_int64], None),
}

_lock = threading.Lock()
_lib = None
_error = None   # a failed build or load, raised again without rebuilding


def lib_path() -> Path:
    """``BUILD_DIR / libfcvsr_loader_<hash>.so``, the hash of the flags and
    the source."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfcvsr_loader_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    target = lib_path()
    if target.is_file():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("fcvsr_tpu_torch: g++ not found on PATH; the PNG "
                           "decoder is built from csrc/host/loader.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, target.name)
        cmd = [cxx, *CXX_FLAGS, "-o", out, str(SOURCE), *LINK]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"fcvsr_tpu_torch: g++ failed "
                               f"({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(out, target)
    return target


def load_library() -> ctypes.CDLL:
    """The decoder's library, built at first use; raises ``RuntimeError``
    (or ``OSError``) if it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(_build()))
                for name, (argtypes, restype) in _SIGNATURES.items():
                    getattr(lib, name).argtypes = argtypes
                    getattr(lib, name).restype = restype
                _lib = lib
            except (RuntimeError, OSError) as err:
                _error = err
        if _error is not None:
            raise _error
        return _lib


def _lib_or_none():
    try:
        return load_library()
    except (RuntimeError, OSError):
        return None


def native_available() -> bool:
    """Whether the decoder's library is built and loaded."""
    return _lib_or_none() is not None


def load_image_native(path: str, grayscale: bool = False) -> np.ndarray:
    """One PNG -> uint8 (H, W, C), C 1 (PIL's luma) or 3 (alpha dropped);
    decoded with PIL where the library is missing or refuses the file."""
    lib = _lib_or_none()
    if lib is not None:
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if lib.fcvsr_png_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                              ctypes.byref(c)) == 0:
            oc = 1 if grayscale else 3
            out = np.empty((h.value, w.value, oc), np.uint8)
            if lib.fcvsr_png_decode(path.encode(), out.ctypes.data_as(_U8P),
                                    oc, ctypes.byref(w),
                                    ctypes.byref(h)) == 0:
                return out
    from .datasets import load_image

    return load_image(path, grayscale)


def load_batch_native(paths: List[str], height: int, width: int,
                      grayscale: bool = False,
                      num_threads: int = 8) -> np.ndarray:
    """PNGs of one size, decoded by ``num_threads`` threads -> uint8 (N, H,
    W, C); one by one (:func:`load_image_native`) without the library or
    where a file fails."""
    lib = _lib_or_none()
    oc = 1 if grayscale else 3
    if lib is None:
        return np.stack([load_image_native(p, grayscale) for p in paths])
    n = len(paths)
    out = np.empty((n, height, width, oc), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if lib.fcvsr_png_decode_batch(arr, n, out.ctypes.data_as(_U8P), oc,
                                  height, width, num_threads) != 0:
        return np.stack([load_image_native(p, grayscale) for p in paths])
    return out


def u8_to_f32_native(arr: np.ndarray) -> np.ndarray:
    """uint8 -> float32 times 1 / 255 (``x / 255`` in numpy without the
    library)."""
    lib = _lib_or_none()
    flat = np.ascontiguousarray(arr, np.uint8)
    if lib is None:
        return flat.astype(np.float32) / 255.0
    out = np.empty(flat.shape, np.float32)
    lib.fcvsr_u8_to_f32(flat.ctypes.data_as(_U8P),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        flat.size)
    return out
