"""Tonemapping and quantization (JAX package ``ops/tonemap.py``).

The path tracer applies the Narkowicz ACES fit on the spp-averaged radiance
(``cuda_path_tracer.py:74-81,52-58``); quantization truncates toward zero
(``int()`` semantics), then clamps to [0, 255].
"""
from __future__ import annotations

import torch

from .v3 import V3


def aces(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES filmic fit, per channel."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return (x * (a * x + b)) / (x * (c * x + d) + e)


def quantize_u8(color: V3) -> V3:
    """[0,1] float → uint8 with truncation, reference semantics
    ``min(255, max(0, int(c * 255)))``."""

    def q(c):
        return torch.clamp(torch.trunc(c * 255.0), 0.0, 255.0).to(torch.uint8)

    return V3(q(color.x), q(color.y), q(color.z))
