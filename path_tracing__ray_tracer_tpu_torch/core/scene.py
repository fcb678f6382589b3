"""Scene container, render settings and area-light helper.

API parity with reference ``core/scene.py``.  The ``Scene`` is a host-side
description; renderers compile it to device SoA arrays once per
(scene, convention) pair and cache the result.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .acceleration import BVHNode
from .geometry import Hittable
from .material import HitRecord
from .math import Ray, Vec3


@dataclass
class CameraParams:
    """Kept for API parity (reference defines but never uses it: ``core/scene.py:10-16``)."""

    lookfrom: Vec3
    lookat: Vec3
    vup: Vec3
    vfov: float
    aspect: float


@dataclass
class RenderSettings:
    """Render configuration (reference: ``core/scene.py:19-24``)."""

    width: int = 800
    height: int = 600
    samples_per_pixel: int = 9
    max_depth: int = 4


class Scene:
    """Object list + light samples + global lighting constants
    (reference: ``core/scene.py:27-64``).

    A host-side *description*: renderers never trace through it — they lower
    it once via :func:`path_tracing__ray_tracer_tpu_torch.compiler.compile_scene`.
    The ``hit`` method is retained as the slow oracle for tests, and the
    ``ambient``/``light_color`` globals are consumed only by the
    ``cpu_raytracer`` physics (SURVEY.md §2 quirk 12).
    """

    def __init__(self):
        self.objects: List[Hittable] = []
        self.bvh_root: Optional[BVHNode] = None
        self.lights: List[Vec3] = []
        self.light_color = Vec3(1.0, 1.0, 1.0)
        self.ambient = Vec3(0.5, 0.5, 0.5)

    def add_object(self, obj: Hittable):
        self.objects.append(obj)

    def add_light_sample(self, pos: Vec3):
        self.lights.append(pos)

    def build_bvh(self):
        """Build the host BVH (in-place reorders ``objects`` — the reference
        does the same, which is why quad pairing hashes rather than relying
        on adjacency)."""
        if self.objects:
            self.bvh_root = BVHNode(self.objects, 0, len(self.objects))

    def primitive_counts(self) -> dict:
        """Per-type object tally (logging/diagnostics)."""
        counts: dict = {}
        for obj in self.objects:
            key = type(obj).__name__
            counts[key] = counts.get(key, 0) + 1
        counts["lights"] = len(self.lights)
        return counts

    def hit(self, ray: Ray, t_min: float, t_max: float, rec: HitRecord) -> bool:
        """Host-side closest-hit query (oracle path; BVH if built, else a
        linear scan with a shrinking upper bound)."""
        if self.bvh_root is not None:
            return self.bvh_root.hit(ray, t_min, t_max, rec)

        probe = HitRecord()
        found = False
        closest = t_max
        for obj in self.objects:
            if not obj.hit(ray, t_min, closest, probe):
                continue
            found = True
            closest = probe.t
            rec.t, rec.point, rec.normal = probe.t, probe.point, probe.normal
            rec.material, rec.u, rec.v = probe.material, probe.u, probe.v
        return found


def create_area_light(
    scene: Scene,
    center: Vec3,
    u_vec: Vec3,
    v_vec: Vec3,
    u_size: float,
    v_size: float,
    n_u: int,
    n_v: int,
):
    """Place an ``n_u × n_v`` grid of point samples approximating an area light
    (reference: ``core/scene.py:67-80``).
    """
    half_u = u_vec.normalize() * (u_size / 2.0)
    half_v = v_vec.normalize() * (v_size / 2.0)
    for i in range(n_u):
        for j in range(n_v):
            ru = (i + 0.5) / n_u - 0.5
            rv = (j + 0.5) / n_v - 0.5
            scene.add_light_sample(center + half_u * (2 * ru) + half_v * (2 * rv))
