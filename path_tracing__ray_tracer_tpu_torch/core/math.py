"""Scene-description math primitives: ``Vec3``, ``Ray``, ``AABB``.

API-compatible with the reference layer (reference: ``core/math.py:4-117``) so that
scenes written against the reference port verbatim.  These classes are *builders
only*: they run on the host while describing a scene and are compiled to SoA
torch tensors by :mod:`path_tracing__ray_tracer_tpu_torch.compiler`.  No renderer ever
traces through them.
"""
from __future__ import annotations

import math

import numpy as np


class Vec3:
    """A 3-vector with operator overloading (reference: ``core/math.py:4-73``).

    Supports scalar multiply, Hadamard multiply, dot/cross, normalize,
    reflect and Snell refraction with total-internal-reflection detection.
    """

    __slots__ = ("x", "y", "z")

    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other: "Vec3") -> "Vec3":
        return Vec3(self.x + other.x, self.y + other.y, self.z + other.z)

    def __sub__(self, other: "Vec3") -> "Vec3":
        return Vec3(self.x - other.x, self.y - other.y, self.z - other.z)

    def __mul__(self, t) -> "Vec3":
        if isinstance(t, Vec3):  # Hadamard product
            return Vec3(self.x * t.x, self.y * t.y, self.z * t.z)
        return Vec3(self.x * t, self.y * t, self.z * t)

    __rmul__ = __mul__

    def __truediv__(self, t) -> "Vec3":
        inv = 1.0 / t
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry -----------------------------------------------------------
    def dot(self, other: "Vec3") -> float:
        return self.x * other.x + self.y * other.y + self.z * other.z

    def cross(self, other: "Vec3") -> "Vec3":
        return Vec3(
            self.y * other.z - self.z * other.y,
            self.z * other.x - self.x * other.z,
            self.x * other.y - self.y * other.x,
        )

    def length(self) -> float:
        return math.sqrt(self.dot(self))

    def normalize(self) -> "Vec3":
        l = self.length()
        if l == 0.0:
            return Vec3(0.0, 0.0, 0.0)
        return self / l

    def reflect(self, normal: "Vec3") -> "Vec3":
        """Mirror this vector about ``normal``: ``v - 2 (v.n) n``."""
        return self - normal * (2.0 * self.dot(normal))

    def refract(self, normal: "Vec3", ni_over_nt: float):
        """Snell refraction of the *normalized* incident vector.

        Returns ``(True, refracted)`` or ``(False, None)`` on total internal
        reflection (reference semantics: ``core/math.py:59-67``).
        """
        uv = self.normalize()
        dt = uv.dot(normal)
        discr = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
        if discr > 0.0:
            refracted = (uv - normal * dt) * ni_over_nt - normal * math.sqrt(discr)
            return True, refracted
        return False, None

    def to_np(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z], dtype=np.float32)

    def to_tuple(self):
        return (self.x, self.y, self.z)

    def __repr__(self) -> str:
        return f"Vec3({self.x:.3f}, {self.y:.3f}, {self.z:.3f})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Vec3)
            and self.x == other.x
            and self.y == other.y
            and self.z == other.z
        )


class Ray:
    """Origin + unconditionally-normalized direction (reference: ``core/math.py:76-82``)."""

    __slots__ = ("origin", "direction")

    def __init__(self, origin: Vec3, direction: Vec3):
        self.origin = origin
        self.direction = direction.normalize()

    def point_at_parameter(self, t: float) -> Vec3:
        return self.origin + self.direction * t


class AABB:
    """Axis-aligned bounding box with the classic slab test (reference: ``core/math.py:85-117``)."""

    __slots__ = ("min", "max")

    def __init__(self, min_pt: Vec3, max_pt: Vec3):
        self.min = min_pt
        self.max = max_pt

    @staticmethod
    def surrounding_box(box0: "AABB", box1: "AABB") -> "AABB":
        small = Vec3(
            min(box0.min.x, box1.min.x),
            min(box0.min.y, box1.min.y),
            min(box0.min.z, box1.min.z),
        )
        big = Vec3(
            max(box0.max.x, box1.max.x),
            max(box0.max.y, box1.max.y),
            max(box0.max.z, box1.max.z),
        )
        return AABB(small, big)

    def hit(self, ray: Ray, t_min: float, t_max: float) -> bool:
        o = (ray.origin.x, ray.origin.y, ray.origin.z)
        d = (ray.direction.x, ray.direction.y, ray.direction.z)
        lo = (self.min.x, self.min.y, self.min.z)
        hi = (self.max.x, self.max.y, self.max.z)
        for axis in range(3):
            inv_d = 1.0 / d[axis] if d[axis] != 0.0 else math.inf
            t0 = (lo[axis] - o[axis]) * inv_d
            t1 = (hi[axis] - o[axis]) * inv_d
            if inv_d < 0.0:
                t0, t1 = t1, t0
            t_min = max(t0, t_min)
            t_max = min(t1, t_max)
            if t_max < t_min:
                return False
        return True

    def centroid(self) -> Vec3:
        return (self.min + self.max) * 0.5
