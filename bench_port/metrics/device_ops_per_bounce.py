"""Device operations (kernels, copies, sets; every symbol) per bounce over
the traced span."""
from bench_port.tracing import per_bounce


def read(run):
    return per_bounce(run.span, len(run.span.ops)) if run.span else None
