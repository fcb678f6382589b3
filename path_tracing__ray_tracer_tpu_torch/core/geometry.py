"""Geometry primitives: finite rectangle ("Plane"), Sphere, Triangle.

API parity with reference ``core/geometry.py``.  The host-side ``hit`` methods
implement the same intersection semantics as the reference and serve as the
slow oracle for tests; renderers consume the compiled SoA form instead
(:mod:`path_tracing__ray_tracer_tpu_torch.compiler`).
"""
from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Optional

import numpy as np

from .material import HitRecord, Material
from .math import AABB, Ray, Vec3

_EPS = 1e-6


class Hittable(ABC):
    """Interface every primitive implements (reference: ``core/geometry.py:8-15``)."""

    @abstractmethod
    def hit(self, ray: Ray, t_min: float, t_max: float, rec: HitRecord) -> bool: ...

    @abstractmethod
    def bounding_box(self) -> AABB: ...


class Plane(Hittable):
    """Anchored finite rectangle with UV axes (reference: ``core/geometry.py:18-75``).

    ``anchor`` is one corner; ``u_dir``/``v_dir`` are the in-plane texture
    axes and ``u_len``/``v_len`` their world-space extents.  Note the
    reference quirk (SURVEY.md §2 quirk 5): the host-side hit derives
    ``v_unit = normal × u_unit`` and ignores ``v_dir``'s direction, while the
    GPU wire format normalizes the *given* ``v_dir``.  Both conventions are
    carried so each renderer can match its reference counterpart.
    """

    def __init__(
        self,
        anchor: Vec3,
        normal: Vec3,
        u_dir: Vec3,
        v_dir: Vec3,
        u_len: float,
        v_len: float,
        material: Material,
    ):
        self.anchor = anchor
        self.normal = normal.normalize()
        self.u_dir = u_dir
        self.v_dir = v_dir
        self.u_len = float(u_len)
        self.v_len = float(v_len)
        self.material = material

        self.u_unit = u_dir.normalize()
        # Host ("cpu") convention: derive v from the right-handed frame.
        self.v_unit = self.normal.cross(self.u_unit).normalize()
        self.u_extent = self.u_len
        self.v_extent = self.v_len

        corners = [
            anchor,
            anchor + self.u_unit * u_len,
            anchor + self.v_unit * v_len,
            anchor + self.u_unit * u_len + self.v_unit * v_len,
        ]
        lo = Vec3(
            min(c.x for c in corners), min(c.y for c in corners), min(c.z for c in corners)
        )
        hi = Vec3(
            max(c.x for c in corners), max(c.y for c in corners), max(c.z for c in corners)
        )
        self.box = AABB(lo, hi)

    def hit(self, ray: Ray, t_min: float, t_max: float, rec: HitRecord) -> bool:
        denom = self.normal.dot(ray.direction)
        if abs(denom) < _EPS:
            return False
        t = (self.anchor - ray.origin).dot(self.normal) / denom
        if t < t_min or t > t_max:
            return False
        p = ray.point_at_parameter(t)
        rel = p - self.anchor
        u_hit = rel.dot(self.u_unit)
        v_hit = rel.dot(self.v_unit)
        if u_hit < 0 or u_hit > self.u_extent or v_hit < 0 or v_hit > self.v_extent:
            return False
        rec.t = t
        rec.point = p
        rec.normal = self.normal
        rec.material = self.material
        rec.u = u_hit / self.u_extent
        rec.v = v_hit / self.v_extent
        return True

    def bounding_box(self) -> AABB:
        return self.box


class Sphere(Hittable):
    """Sphere with two-root selection (reference: ``core/geometry.py:78-114``).

    Sphere UVs are always (0, 0): sphere texturing is unsupported everywhere
    in the reference (SURVEY.md §2 quirk 3) and that behavior is preserved.
    """

    def __init__(self, center: Vec3, radius: float, material: Material):
        self.center = center
        self.radius = float(radius)
        self.material = material
        r = Vec3(self.radius, self.radius, self.radius)
        self.box = AABB(center - r, center + r)

    def hit(self, ray: Ray, t_min: float, t_max: float, rec: HitRecord) -> bool:
        oc = ray.origin - self.center
        a = ray.direction.dot(ray.direction)
        b = oc.dot(ray.direction)
        c = oc.dot(oc) - self.radius * self.radius
        disc = b * b - a * c
        if disc <= 0:
            return False
        sqrt_d = math.sqrt(disc)
        for root in ((-b - sqrt_d) / a, (-b + sqrt_d) / a):
            if t_min < root < t_max:
                rec.t = root
                rec.point = ray.point_at_parameter(root)
                rec.normal = (rec.point - self.center) / self.radius
                rec.material = self.material
                rec.u = 0.0
                rec.v = 0.0
                return True
        return False

    def bounding_box(self) -> AABB:
        return self.box


class Triangle(Hittable):
    """Möller–Trumbore triangle with optional per-vertex UVs
    (reference: ``core/geometry.py:117-174``).  Double-sided: the stored
    face normal is flipped toward the incoming ray.
    """

    def __init__(
        self,
        v0: Vec3,
        v1: Vec3,
        v2: Vec3,
        uv0: Optional[np.ndarray] = None,
        uv1: Optional[np.ndarray] = None,
        uv2: Optional[np.ndarray] = None,
        material: Material = None,
    ):
        self.v0, self.v1, self.v2 = v0, v1, v2
        self.uv0, self.uv1, self.uv2 = uv0, uv1, uv2
        self.material = material
        self.normal = (v1 - v0).cross(v2 - v0).normalize()
        lo = Vec3(
            min(v0.x, v1.x, v2.x), min(v0.y, v1.y, v2.y), min(v0.z, v1.z, v2.z)
        )
        hi = Vec3(
            max(v0.x, v1.x, v2.x), max(v0.y, v1.y, v2.y), max(v0.z, v1.z, v2.z)
        )
        self.box = AABB(lo, hi)

    def hit(self, ray: Ray, t_min: float, t_max: float, rec: HitRecord) -> bool:
        e1 = self.v1 - self.v0
        e2 = self.v2 - self.v0
        h = ray.direction.cross(e2)
        det = e1.dot(h)
        if abs(det) < _EPS:
            return False
        inv_det = 1.0 / det
        s = ray.origin - self.v0
        u = inv_det * s.dot(h)
        if u < 0.0 or u > 1.0:
            return False
        q = s.cross(e1)
        v = inv_det * ray.direction.dot(q)
        if v < 0.0 or u + v > 1.0:
            return False
        t = inv_det * e2.dot(q)
        if not (t_min < t < t_max):
            return False
        rec.t = t
        rec.point = ray.point_at_parameter(t)
        rec.normal = self.normal if self.normal.dot(ray.direction) < 0 else -self.normal
        rec.material = self.material
        if self.uv0 is not None:
            w = 1.0 - u - v
            rec.u = u * self.uv1[0] + v * self.uv2[0] + w * self.uv0[0]
            rec.v = u * self.uv1[1] + v * self.uv2[1] + w * self.uv0[1]
        else:
            rec.u, rec.v = 0.0, 0.0
        return True

    def bounding_box(self) -> AABB:
        return self.box
