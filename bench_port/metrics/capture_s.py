"""Seconds the program spent capturing CUDA graphs in set-up (its own
``ops.cuda.CAPTURES`` record: one capture a bucket width of a chunk shape)."""


def read(run):
    return run.capture_s
