"""Vectorized primary-ray generation from the packed 12-float camera.

Counterpart of the JAX package's ``ops/camera.py`` (reference
``cuda_get_ray``, ``cuda_texture_renderer.py:83-114``):
``dir = llc + u·horizontal + v·vertical − origin``, normalized.
"""
from __future__ import annotations

import torch

from .v3 import V3


def unpack_camera(cam12: torch.Tensor):
    """Split the wire format into (origin, lower_left, horizontal, vertical)."""
    origin = V3(cam12[0], cam12[1], cam12[2])
    llc = V3(cam12[3], cam12[4], cam12[5])
    horizontal = V3(cam12[6], cam12[7], cam12[8])
    vertical = V3(cam12[9], cam12[10], cam12[11])
    return origin, llc, horizontal, vertical


def generate_rays(cam12: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Primary rays for screen-space coordinates ``u, v ∈ [0,1]`` (any shape).

    Returns ``(origins, directions)`` as SoA ``V3``; directions are unit
    length (the reference normalizes with a zero guard).
    """
    origin, llc, horizontal, vertical = unpack_camera(cam12)
    d = llc + horizontal * u + vertical * v - origin
    d = d.normalized()
    o = V3(*(c.expand(u.shape).contiguous() for c in origin))
    return o, d
