"""The port's spans and counters, its profiler trace, and the reference's
ray-counting formula (``main.py:104-108``): ``width · height · spp · depth /
seconds``.

A :class:`span` marks a stretch of the program's host code by name (the
renderer's ``render``, ``finish`` and ``device_sums``; the scheduler's
``chunk``, ``drive``, ``block.*`` and ``graph.capture``).  While a profiler
records (the CLI's ``--trace-dir``, :func:`maybe_trace`, or any
``torch.profiler.profile``), a span is a range ``ptrt.<name>`` among the
profiler's host operations, on the clock of the card's events: an operator's
range (``_RecordFunctionFast``), not ``record_function``'s user annotation,
which the profiler would mirror onto the card's timeline as a device event.
Otherwise it adds its host nanoseconds and one call to the process's record
under ``<name>``; :func:`count` adds integers there (the scheduler's
``lanes.*``) either way.  So the record holds only untraced time:
a span that began or ended under a profiler, or that holds a span opened
under one, adds nothing.  A span makes no device allocation and no sync, and
no span sits inside a captured CUDA graph.

:func:`record` reads the record, ``{name: [count, ns]}``; a mesh worker's part
comes back with its chunk and :func:`add_record` adds it on, under
``worker.<name>``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_clock = time.perf_counter_ns
_RECORD: Dict[str, List[int]] = {}  # name -> [count, ns]
_TRACED = [0]  # spans opened under a profiler in this process


class span:
    """``with span(name) as s:`` a named stretch of host code; ``s.ns`` (and
    ``s.seconds``) is its length by the host clock after the block, traced
    or not."""

    __slots__ = ("name", "ns", "_t0", "_rf", "_mark")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0

    def __enter__(self) -> "span":
        if _profiler_enabled():
            _TRACED[0] += 1
            self._rf = _RecordFunctionFast("ptrt." + self.name)
            self._rf.__enter__()
        else:
            self._rf = None
            self._mark = _TRACED[0]
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.ns = _clock() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        elif self._mark == _TRACED[0] and not _profiler_enabled():
            entry = _RECORD.setdefault(self.name, [0, 0])
            entry[0] += 1
            entry[1] += self.ns
        return False

    @property
    def seconds(self) -> float:
        return self.ns / 1e9


def count(name: str, n: int) -> None:
    """Add ``n`` to the count of ``name`` in the record, traced or not."""
    _RECORD.setdefault(name, [0, 0])[0] += n


def record() -> Dict[str, List[int]]:
    """A copy of this process's record: ``{name: [count, ns]}`` (a counter's
    ``ns`` is 0)."""
    return {name: list(entry) for name, entry in _RECORD.items()}


def add_record(delta: Dict[str, List[int]]) -> None:
    """Add ``delta`` (a mesh worker's part, as :func:`record` gives it) onto
    this process's record, each ``name`` as ``worker.<name>``: the workers'
    spans run at once, inside the parent's ``chunk``, so they stay apart
    from the parent's own."""
    for name, (n, ns) in delta.items():
        entry = _RECORD.setdefault("worker." + name, [0, 0])
        entry[0] += n
        entry[1] += ns


def mrays_per_sec(width: int, height: int, spp: int, depth: int, seconds: float) -> float:
    total_rays = width * height * spp * depth
    return total_rays / max(seconds, 1e-12) / 1e6


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """A ``torch.profiler`` trace of the scope (host operations with the
    port's ``ptrt.*`` spans, and the card's kernels when torch sees one),
    written as a Chrome trace ``trace_<pid>_<ms>.json`` into ``trace_dir``
    when one is given."""
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
