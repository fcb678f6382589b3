"""Device milliseconds per bounce of every device operation that is not one
of the port's own kernels (the glue: RNG, texture, vector ops, copies)."""
from bench_port.tracing import per_bounce


def read(run):
    return per_bounce(run.span, run.span.device_ms(port=False)) if run.span else None
