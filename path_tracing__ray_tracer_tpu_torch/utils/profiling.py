"""Timing and throughput reporting with the reference's ray-counting formula
(``main.py:104-108``): ``width · height · spp · depth / seconds``.
Optionally wraps a render in a ``torch.profiler`` trace (:func:`maybe_trace`).
"""
from __future__ import annotations

import contextlib
import os
import time


def mrays_per_sec(width: int, height: int, spp: int, depth: int, seconds: float) -> float:
    total_rays = width * height * spp * depth
    return total_rays / max(seconds, 1e-12) / 1e6


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """A ``torch.profiler`` trace of the scope (host operations, and the
    card's kernels when torch sees one), written as a Chrome trace
    ``trace_<pid>_<ms>.json`` into ``trace_dir`` when one is given."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the scope's kernels end inside the trace
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    from .logging import log_event

    log_event("trace_written", path=path)
