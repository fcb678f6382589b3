"""Host runtime calls that launch device work (``cudaLaunchKernel``...,
``cudaGraphLaunch``) per bounce over the traced span of a final-frame
cell."""
from bench_port.tracing import per_bounce


def read(run):
    return per_bounce(run.span, run.span.launch_calls) if run.span else None
