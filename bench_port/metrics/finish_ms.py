"""Milliseconds of a frame's finish: the mean of the program's ``finish``
span in ``render()`` (tone map, quantise, the uint8 transfer, which waits
for the frame's last device work, and the image's assembly), over the run's
warm-up and untraced window (``bench_port/record.py``)."""
from bench_port import record


def read(run):
    return record.mean(run, "finish", 1e6)
