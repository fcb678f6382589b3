"""The median (nearest rank) of the latency of every frame in the window
that ran outside the profiler, from the call of ``render()`` to the uint8
image on the host."""
import math


def read(run):
    lat = sorted(r.seconds * 1e3 if r.ok else math.inf for r in run.requests if not r.traced)
    if not lat or run.shape.entry != "render":
        return None
    return lat[math.ceil(0.5 * len(lat)) - 1]
