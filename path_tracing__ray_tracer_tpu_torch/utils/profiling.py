"""Throughput reporting with the reference's ray-counting formula
(``main.py:104-108``): ``width · height · spp · depth / seconds``."""
from __future__ import annotations

import time


def mrays_per_sec(width: int, height: int, spp: int, depth: int, seconds: float) -> float:
    total_rays = width * height * spp * depth
    return total_rays / max(seconds, 1e-12) / 1e6


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False
