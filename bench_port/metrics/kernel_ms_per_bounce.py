"""Device milliseconds per bounce of the port's own kernels (``csrc/*.cu``,
the ``ptrt`` namespace)."""
from bench_port.tracing import per_bounce


def read(run):
    return per_bounce(run.span, run.span.device_ms(port=True)) if run.span else None
