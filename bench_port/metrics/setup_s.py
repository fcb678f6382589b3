"""Seconds from the process's start to the window's first request: imports,
the card's context, the kernels' build or load, the scene's compile and the
warm-up requests (graph captures among them)."""


def read(run):
    return run.setup_s
