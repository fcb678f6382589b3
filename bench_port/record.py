"""The program's own spans and counters, as the benchmark reads them: the
port's ``utils/profiling.record()``, ``{name: [count, ns]}`` (a counter's
``ns`` is 0), as ``program.captures()`` reads ``ops/cuda.CAPTURES``.

A reader reads the record of the whole run process when the metrics are
read, after the window: the warm-up requests (of the window's shape) and the
window, less the profiled stretch of a ``--trace 1`` run, since a span under
the profiler is a range of its trace and not an entry of the record (the
counters count there too).  A program without the record gives ``{}``, and
its readers None.

Per-layer metrics are read in ``--trace 1`` runs only, whose window follows
the profiled span; after it every graph launch of the process takes about
ten times its untraced host time (PERF.md §5).  So the readers here take
counters, or a span that the slower launches hardly move (``finish``:
18.3-24.3 ms a frame traced, 19.5-21.0 ms untraced on an H100), and not the
spans around the blocks."""
from __future__ import annotations

from typing import Dict, List, Optional


def of(run) -> Dict[str, List[int]]:
    """``run.record`` where the run carries one, else the program's record
    (``{}`` where the program keeps none)."""
    rec = getattr(run, "record", None)
    if rec is not None:
        return rec
    try:
        from path_tracing__ray_tracer_tpu_torch.utils.profiling import record
    except ImportError:
        return {}
    return record()


def mean(run, name: str, unit_ns: float) -> Optional[float]:
    """The mean length of the span ``name`` in units of ``unit_ns``
    nanoseconds, or None where it never ran."""
    n, ns = of(run).get(name, (0, 0))
    return ns / n / unit_ns if n else None
