"""Pinhole camera (API parity with reference ``core/camera.py:5-31``).

Precomputes the image-plane basis; ``get_ray`` is the host-side oracle path.
Renderers consume ``packed()`` — the 12-float wire format
``[origin, lower_left_corner, horizontal, vertical]`` established by the
reference GPU path (``cuda_renderer.py:655-662``).
"""
from __future__ import annotations

import math

import numpy as np

from .math import Ray, Vec3


class Camera:
    def __init__(self, lookfrom: Vec3, lookat: Vec3, vup: Vec3, vfov: float, aspect: float):
        self.origin = lookfrom

        theta = math.radians(vfov)
        half_height = math.tan(theta / 2.0)
        half_width = aspect * half_height

        w = (lookfrom - lookat).normalize()
        u = vup.cross(w).normalize()
        v = w.cross(u)

        self.lower_left_corner = self.origin - u * half_width - v * half_height - w
        self.horizontal = u * (2.0 * half_width)
        self.vertical = v * (2.0 * half_height)

    def get_ray(self, s: float, t: float) -> Ray:
        direction = (
            self.lower_left_corner
            + self.horizontal * s
            + self.vertical * t
            - self.origin
        )
        return Ray(self.origin, direction)

    def packed(self) -> np.ndarray:
        """12-float wire format: origin, lower-left corner, horizontal, vertical."""
        return np.concatenate(
            [
                self.origin.to_np(),
                self.lower_left_corner.to_np(),
                self.horizontal.to_np(),
                self.vertical.to_np(),
            ]
        ).astype(np.float32)
