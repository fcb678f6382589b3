"""Hand-written CUDA kernels (sources under ``csrc/``), each beside its plain
torch version.  Each kernel's wrapper counts its launches on ``.launches``
(the plain version does not count); :func:`launch_counts` reads them all and
:func:`add_launches` adds counts made elsewhere (a mesh worker's) onto them.
A wrapper counts on the host when it launches, so a CUDA graph capture of
it counts once and a replay not at all: :func:`capture` (the path
tracer's bounce blocks, ``models/path_tracer.BounceBlocks``) takes a
capture's counts back with :func:`launches_of`, and each replay adds them,
so the counts equal an eager run's."""
from __future__ import annotations

import importlib
import pkgutil
import time
from typing import Callable, Dict, List, Tuple

import torch


def wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper of this package by ``module.name`` (the first
    name a module binds it to)."""
    found: Dict[int, tuple] = {}
    for info in pkgutil.iter_modules(__path__):
        m = importlib.import_module(f"{__name__}.{info.name}")
        for name, fn in vars(m).items():
            if isinstance(getattr(fn, "launches", None), int) and fn.__module__ == m.__name__:
                found.setdefault(id(fn), (f"{info.name}.{name}", fn))
    return dict(found.values())


def launch_counts() -> Dict[str, int]:
    """Each wrapper's launch count, by ``module.name``."""
    return {key: fn.launches for key, fn in wrappers().items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by ``module.name``, as :func:`launch_counts` gives
    them) onto the wrappers' launch counts."""
    found = wrappers()
    for key, n in counts.items():
        found[key].launches += n


def launches_of(run: Callable[[], object]) -> List[Tuple[Callable, int]]:
    """Call ``run()`` and return the launches it counted, as ``(wrapper,
    n)`` pairs, after taking them back off the wrappers' counts: for a CUDA
    graph capture, which counts the launches it records and runs none."""
    found = wrappers()
    before = {key: fn.launches for key, fn in found.items()}
    run()
    counted = [(fn, fn.launches - before[key]) for key, fn in found.items()
               if fn.launches != before[key]]
    for fn, n in counted:
        fn.launches -= n
    return counted


# Graph captures of this process: their count and host seconds (the eager
# warm-up block before each excluded); a mesh worker sends its own back.
CAPTURES = {"count": 0, "seconds": 0.0}
_SIDE = {}  # device index -> the side stream of warm-ups and captures


def capture(block, dev):
    """``(graph, launches)``: ``block()`` run once eagerly on the device's
    side stream (the warm-up torch asks for before a capture; it is the
    loop's own next block, so its launches count), then captured there.
    ``launches``: the launches the capture counted, by wrapper, taken back
    off the wrappers (a replay adds them).  The persistent kernels of the
    graph take the side stream's lane counter (``bvh.lane_counter``), made
    before the warm-up; every replay runs on the caller's stream, ordered
    after the warm-up, so no eager launch on another stream shares it.  Each
    graph keeps its own memory pool, from which the wrappers' outputs inside
    the block are taken."""
    from .bvh import lane_counter

    if dev.index not in _SIDE:
        _SIDE[dev.index] = torch.cuda.Stream(dev)
    side, here = _SIDE[dev.index], torch.cuda.current_stream(dev)
    side.wait_stream(here)
    with torch.cuda.stream(side):
        lane_counter(dev)  # made here, outside the capture's memory pool
        block()
    here.wait_stream(side)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()

    def record():  # torch.cuda.graph's capture, less its synchronize and empty_cache
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                block()
            finally:
                graph.capture_end()

    launches = launches_of(record)
    CAPTURES["count"] += 1
    CAPTURES["seconds"] += time.perf_counter() - t0
    return graph, launches
