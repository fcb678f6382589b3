"""Host-side BVH for the oracle path (API parity with reference ``core/acceleration.py``).

Deliberate fix over the reference: the reference picks a *random* split axis
per node (``core/acceleration.py:9``), making the tree — and therefore
tie-broken hit results — nondeterministic across runs (SURVEY.md §2 quirk 11).
This implementation splits on the largest centroid extent instead, so builds
are reproducible.  The device-side flat BVH is not ported yet (ROADMAP
Queue 1, BVH item); the JAX package's ``ops/bvh.py`` is its reference.
"""
from __future__ import annotations

from .material import HitRecord
from .math import AABB, Ray


class BVHNode:
    """Median-split binary BVH over a slice ``objects[start:end]``."""

    __slots__ = ("left", "right", "box")

    def __init__(self, objects, start: int, end: int):
        span = end - start
        axis = _largest_extent_axis(objects, start, end)
        key = (
            (lambda o: o.bounding_box().min.x),
            (lambda o: o.bounding_box().min.y),
            (lambda o: o.bounding_box().min.z),
        )[axis]

        if span == 1:
            self.left = self.right = objects[start]
        elif span == 2:
            a, b = objects[start], objects[start + 1]
            self.left, self.right = (a, b) if key(a) <= key(b) else (b, a)
        else:
            ordered = sorted(objects[start:end], key=key)
            objects[start:end] = ordered
            mid = start + span // 2
            self.left = BVHNode(objects, start, mid)
            self.right = BVHNode(objects, mid, end)

        self.box = AABB.surrounding_box(
            self.left.bounding_box(), self.right.bounding_box()
        )

    def bounding_box(self) -> AABB:
        return self.box

    def hit(self, ray: Ray, t_min: float, t_max: float, rec: HitRecord) -> bool:
        if not self.box.hit(ray, t_min, t_max):
            return False
        hit_left = self.left.hit(ray, t_min, t_max, rec)
        hit_right = self.right.hit(ray, t_min, rec.t if hit_left else t_max, rec)
        return hit_left or hit_right


def _largest_extent_axis(objects, start: int, end: int) -> int:
    lo = [float("inf")] * 3
    hi = [float("-inf")] * 3
    for obj in objects[start:end]:
        c = obj.bounding_box().centroid()
        for axis, value in enumerate((c.x, c.y, c.z)):
            lo[axis] = min(lo[axis], value)
            hi[axis] = max(hi[axis], value)
    extents = [hi[a] - lo[a] for a in range(3)]
    return max(range(3), key=lambda a: extents[a])
