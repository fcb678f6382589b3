"""Three-component vectors as three tensors (structure of arrays)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class V(NamedTuple):
    """Three tensors, one per component."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return V(self.x + o.x, self.y + o.y, self.z + o.z) if isinstance(o, V) else \
            V(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        return V(self.x - o.x, self.y - o.y, self.z - o.z) if isinstance(o, V) else \
            V(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        return V(self.x * o.x, self.y * o.y, self.z * o.z) if isinstance(o, V) else \
            V(self.x * o, self.y * o, self.z * o)

    def __neg__(self):
        return V(-self.x, -self.y, -self.z)

    def dot(self, o) -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o) -> "V":
        return V(self.y * o.z - self.z * o.y, self.z * o.x - self.x * o.z,
                 self.x * o.y - self.y * o.x)

    def unit(self) -> "V":
        n = torch.sqrt(self.dot(self))
        pos = n > 0.0
        s = self * (1.0 / torch.where(pos, n, 1.0))
        return pick(pos, s, V(*(torch.zeros_like(c) for c in s)))

    def col(self) -> "V":
        """(N,) components as (N, 1), to broadcast against (P,) tables."""
        return V(self.x[:, None], self.y[:, None], self.z[:, None])

    def at(self, i) -> "V":
        return V(self.x[i], self.y[i], self.z[i])


def pick(mask, a: V, b: V) -> V:
    return V(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y), torch.where(mask, a.z, b.z))
