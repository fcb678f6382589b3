"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each library is compiled at first use into ``_build/`` inside the package
(listed in ``.gitignore``), named by a hash of its sources and flags, so a
changed source rebuilds and an unchanged one loads at once.  The sources
expose plain ``extern "C"`` launchers; nothing includes PyTorch's headers, so
a build takes seconds.

Each kernel library is named in :data:`KERNELS` with its sources and the
headers they include.  :func:`load_all` starts one ``nvcc`` per missing
library at once and waits for all of them.

Nothing here runs at import time: the package imports on machines with
neither ``nvcc`` nor a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, NamedTuple, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"

# --fmad=false: every product and sum rounds on its own, as the plain torch
# ops do, so the kernels compare tightly with their plain versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)


# library name -> (sources, headers), all under csrc/
KERNELS: Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {
    "path_bounce": (("path_bounce.cu",), ("sweep.cuh", "bvh_walk.cuh", "path_shade.cuh")),
    "intersect": (("intersect.cu",), ("sweep.cuh",)),
    "whitted_bounce": (("whitted_bounce.cu",), ("sweep.cuh", "bvh_walk.cuh")),
    "bvh_scene": (("bvh_scene.cu",), ("sweep.cuh", "bvh_walk.cuh")),
    "path_bounce_bvh": (("path_bounce_bvh.cu",), ("sweep.cuh", "bvh_walk.cuh", "path_shade.cuh")),
    "bvh_paged": (("bvh_paged.cu",), ("sweep.cuh", "bvh_walk.cuh")),
    "bvh2": (("bvh2_walk.cu",), ("sweep.cuh", "bvh_walk.cuh")),
    "bvh_leafmat": (("bvh_leafmat.cu",), ("sweep.cuh", "bvh_walk.cuh")),
    "path_step": (("path_step.cu",), ("sweep.cuh", "bvh_walk.cuh", "path_shade.cuh")),
    "texture_gather": (("texture_gather.cu",), ()),
}


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of this build's nvcc; 0.0 when an earlier build was reused
    log: str  # nvcc/ptxas output of this build ("" when reused)


_LOADED: Dict[str, Built] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(name: str) -> Path:
    sources, headers = KERNELS[name]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (*sources, *headers):
        digest.update(f.encode())
        digest.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def load_all(names: Sequence[str] = tuple(KERNELS)) -> Dict[str, Built]:
    """Compile the libraries ``names`` that have no build for their current
    sources, all ``nvcc`` processes at once, and load each one; one build per
    content hash, one load per process."""
    todo = [n for n in names if n not in _LOADED]
    running = {}
    for name in todo:
        path = _library_path(name)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in KERNELS[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path, time.perf_counter())
    logs, failed = {}, []
    for name, (proc, tmp, path, t0) in running.items():
        out, _ = proc.communicate()
        logs[name] = (time.perf_counter() - t0, out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}) for {name}:\n{out}")
        else:
            os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in todo:
        path = _library_path(name)
        seconds, log = logs.get(name, (0.0, ""))
        _LOADED[name] = Built(ctypes.CDLL(str(path)), path, seconds, log)
    return {n: _LOADED[n] for n in names}


def load(name: str) -> Built:
    """Compile (once per source hash) and load the library ``name`` of
    :data:`KERNELS`."""
    return load_all((name,))[name]
