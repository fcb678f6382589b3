"""Monte-Carlo sampling primitives for the path tracer.

Counterparts of the JAX package's ``ops/sampling.py``: cosine-weighted
hemisphere sampling with the reference's tangent frame
(``cuda_path_tracer.py:139-180``) and uniform point-light selection with
``pdf = 1/num_lights`` (``cuda_path_tracer.py:183-210``).  The light pick is
plain indexing: the JAX package's select chain exists only because per-lane
gathers are slow on the TPU, and it copies rows bit for bit.
"""
from __future__ import annotations

import torch

from .v3 import V3

TWO_PI = 6.283185307179586


def cosine_hemisphere(normal: V3, r1: torch.Tensor, r2: torch.Tensor) -> V3:
    """Cosine-weighted direction about ``normal`` from two uniforms."""
    cos_theta = torch.sqrt(r1)
    sin_theta = torch.sqrt(torch.clamp(1.0 - r1, min=0.0))
    phi = TWO_PI * r2
    lx = sin_theta * torch.cos(phi)
    ly = sin_theta * torch.sin(phi)
    lz = cos_theta

    # reference tangent frame: nt = |n.z| > 0.9 ? x̂ : ẑ ; u = nt × n ; v = n × u
    steep = torch.abs(normal.z) > 0.9
    zero = torch.zeros_like(normal.x)
    nt = V3(torch.where(steep, 1.0, zero), zero, torch.where(steep, zero, 1.0))
    u = nt.cross(normal).normalized()
    v = normal.cross(u)
    return u * lx + v * ly + normal * lz


def pick_light(cs, point: V3, r: torch.Tensor):
    """Uniformly pick one light sample per ray.

    Returns ``(direction, distance, pdf)`` with ``pdf = 1/num_lights``.
    """
    n_lights = cs.n_lights
    li = torch.clamp((r * n_lights).to(torch.int32), max=n_lights - 1)
    lp = cs.lights.take(li)
    to_light = lp - point
    dist = to_light.norm()
    ldir = to_light * (1.0 / torch.where(dist > 0.001, dist, 1.0))
    return ldir, dist, 1.0 / n_lights
