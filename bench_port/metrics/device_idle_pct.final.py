"""Share of the traced span of a final-frame cell in which no device
operation ran: 100 × (1 − the union of the span's device intervals / the
untraced time of the same calls in a later request of the run).  The
profiler slows the host between graph-launched kernels, so the traced
span's own length would count that slowdown as idle."""


def read(run):
    s = run.span
    if s is None or not s.ops or not s.untraced_s:
        return None
    return 100.0 * (1.0 - s.busy_s() / s.untraced_s)
