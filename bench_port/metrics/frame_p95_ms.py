"""The 95th percentile (nearest rank) of every frame's latency in the
window, from the call of ``render()`` to the uint8 image on the host; a
frame that failed counts as missing any limit."""
import math


def read(run):
    lat = sorted(r.seconds * 1e3 if r.ok else math.inf for r in run.requests)
    if not lat or run.shape.entry != "render":
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
