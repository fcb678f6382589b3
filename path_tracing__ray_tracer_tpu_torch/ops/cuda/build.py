"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each library is compiled at first use into ``_build/`` inside the package
(listed in ``.gitignore``), named by a hash of its sources and flags, so a
changed source rebuilds and an unchanged one loads at once.  The sources
expose plain ``extern "C"`` launchers; nothing includes PyTorch's headers, so
a build takes seconds.

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
from typing import Dict, NamedTuple, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"

# --fmad=false: every product and sum rounds on its own, as the plain torch
# ops do, so the kernels compare tightly with their plain versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
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


def load(name: str, sources: Sequence[str], headers: Sequence[str] = ()) -> Built:
    """Compile ``sources`` (file names under ``csrc/``) into ``lib<name>`` and
    load it; one build per content hash, one load per process."""
    if name in _LOADED:
        return _LOADED[name]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (*sources, *headers):
        digest.update(f.encode())
        digest.update((CSRC / f).read_bytes())
    path = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    built = Built(ctypes.CDLL(str(path)), path, seconds, log)
    _LOADED[name] = built
    return built
