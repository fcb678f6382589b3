"""Compile ``bvh_builder.cpp`` with the system C++ compiler and bind it.

The library goes into the package's ``_build/`` (git-ignored, shared with
the CUDA kernels' builds), named by a hash of the source, so an unchanged
source is compiled once.  Every failure raises :class:`NativeUnavailable`
with its reason; the caller decides what to do instead.
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

import numpy as np

SOURCE = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None


class NativeUnavailable(RuntimeError):
    """The native builder cannot be used; the message says why."""


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        cxx = next((c for c in (os.environ.get("CXX"), "g++", "clang++") if c and shutil.which(c)),
                   None)
        if cxx is None:
            raise NativeUnavailable("no C++ compiler (CXX, g++, clang++) on PATH")
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
        path = BUILD_DIR / f"libptrt_bvh_{digest}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run([cxx, *_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                                  text=True, timeout=120)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise NativeUnavailable(f"{cxx} failed ({proc.returncode}): {proc.stderr[-500:]}")
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeUnavailable(f"cannot load {path.name}: {e}") from e
        f32, i32 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        lib.ptrt_build_bvh.restype = ctypes.c_int
        lib.ptrt_build_bvh.argtypes = [f32, f32, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32,
                                       f32, i32, ctypes.POINTER(ctypes.c_uint8), i32]
        _LIB = lib
        return lib


def native_build_bvh(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int) -> dict:
    """The C++ builder's flat BVH over triangle AABBs ``(T, 3)``: the same
    ``lo``, ``hi``, ``skip``, ``is_leaf`` and ``slots`` arrays as the numpy
    builder of ``ops/bvh.py``."""
    lib = _load()
    t = tri_min.shape[0]
    tri_min = np.ascontiguousarray(tri_min, dtype=np.float32)
    tri_max = np.ascontiguousarray(tri_max, dtype=np.float32)
    max_nodes = 4 * t + 16
    lo = np.empty((max_nodes, 3), np.float32)
    hi = np.empty((max_nodes, 3), np.float32)
    skip = np.empty(max_nodes, np.int32)
    is_leaf = np.empty(max_nodes, np.uint8)
    slots = np.empty((max_nodes, leaf_size), np.int32)

    def p(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    n = lib.ptrt_build_bvh(p(tri_min, ctypes.c_float), p(tri_max, ctypes.c_float), t, leaf_size,
                           max_nodes, p(lo, ctypes.c_float), p(hi, ctypes.c_float),
                           p(skip, ctypes.c_int32), p(is_leaf, ctypes.c_uint8),
                           p(slots, ctypes.c_int32))
    if n <= 0:
        raise NativeUnavailable(f"builder returned {n} for {t} triangles ({max_nodes} node slots)")
    return {"lo": lo[:n].copy(), "hi": hi[:n].copy(), "skip": skip[:n].copy(),
            "is_leaf": is_leaf[:n].astype(bool), "slots": slots[:n].copy()}
