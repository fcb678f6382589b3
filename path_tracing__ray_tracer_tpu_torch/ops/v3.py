"""SoA 3-vectors: three separate tensors instead of a trailing dim of 3.

The port keeps the JAX package's structure-of-arrays form (``ops/v3.py``
there) so that every tensor compares 1:1 with its JAX array, and so that the
CUDA kernels read each component as one coalesced ``(N,)`` stream.

Components may be 0-d or ``(N,)`` tensors (or Python floats); every op
broadcasts like torch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- construction -----------------------------------------------------
    @staticmethod
    def of(x, y, z, device=None) -> "V3":
        return V3(
            torch.as_tensor(x, dtype=torch.float32, device=device),
            torch.as_tensor(y, dtype=torch.float32, device=device),
            torch.as_tensor(z, dtype=torch.float32, device=device),
        )

    @staticmethod
    def from_array(a) -> "V3":
        """From a trailing-dim-3 tensor (host/wire format) to SoA."""
        a = torch.as_tensor(a, dtype=torch.float32)
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):  # Hadamard
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- geometry ----------------------------------------------------------
    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def norm(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))

    def normalized(self, eps: float = 0.0) -> "V3":
        """Unit vector; matches the reference's guard (zero stays zero)."""
        n = self.norm()
        pos = n > eps
        scaled = self * (1.0 / torch.where(pos, n, 1.0))
        return V3.where(pos, scaled, V3(0.0, 0.0, 0.0))

    def reflect(self, n: "V3") -> "V3":
        """``v - 2 (v.n) n``."""
        return self - n * (2.0 * self.dot(n))

    # -- selection / reductions ---------------------------------------------
    @staticmethod
    def where(mask, a: "V3", b: "V3") -> "V3":
        return V3(
            torch.where(mask, a.x, b.x),
            torch.where(mask, a.y, b.y),
            torch.where(mask, a.z, b.z),
        )

    def max_component(self) -> torch.Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def luminance(self) -> torch.Tensor:
        """Rec.601 luma, as used by the reference's Russian roulette
        (``cuda_path_tracer.py:308``)."""
        return 0.299 * self.x + 0.587 * self.y + 0.114 * self.z

    def take(self, idx) -> "V3":
        """Gather components by index tensor."""
        return V3(self.x[idx], self.y[idx], self.z[idx])

    def at_index(self, i) -> "V3":
        """Row ``i`` (an int, or a slice for the whole table)."""
        return V3(self.x[i], self.y[i], self.z[i])


def refract(incident: V3, normal: V3, ni_over_nt) -> tuple[torch.Tensor, V3]:
    """Branchless Snell refraction (semantics of ``cuda_texture_renderer.py:146-170``).

    Returns ``(refracted_mask, direction)``; where the mask is False the
    direction is unspecified (caller selects the TIR fallback).
    """
    cos_i = -incident.dot(normal)
    sin2_t = ni_over_nt * ni_over_nt * (1.0 - cos_i * cos_i)
    ok = sin2_t <= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    out = incident * ni_over_nt + normal * (ni_over_nt * cos_i - cos_t)
    return ok, out
