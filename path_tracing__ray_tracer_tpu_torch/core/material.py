"""Materials, textures and hit records (API parity with reference ``core/material.py``).

``Texture`` keeps the decoded image on the host; the scene compiler bakes all
textures of a scene into a single device-resident atlas
(:mod:`path_tracing__ray_tracer_tpu_torch.ops.texture`).  ``Texture.sample`` exists for
the host-side oracle path and tests.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .math import Vec3


class Texture:
    """A decoded RGB image, nearest-neighbour sampled with a V flip.

    Reference semantics: ``core/material.py:6-21`` — ``(u, v)`` in ``[0, 1]²``
    with ``(0, 0)`` the bottom-left of the *texture space* (the V axis is
    flipped when indexing because image rows run top-to-bottom).
    """

    def __init__(self, path: str):
        from PIL import Image

        self.path = path
        with Image.open(path) as img:
            rgb = img.convert("RGB")
            self.width, self.height = rgb.size
            self.pixels = np.asarray(rgb, dtype=np.uint8)  # (H, W, 3)

    def sample(self, u: float, v: float) -> Vec3:
        iu = int(max(0, min(self.width - 1, u * (self.width - 1))))
        iv = int(max(0, min(self.height - 1, (1.0 - v) * (self.height - 1))))
        r, g, b = self.pixels[iv, iu]
        return Vec3(r / 255.0, g / 255.0, b / 255.0)


class Material:
    """Phong-style material record (reference: ``core/material.py:24-48``).

    ``color`` is the albedo used when no texture is attached; ``diffuse`` /
    ``specular`` scale the Lambert / Phong terms; ``reflective`` and
    ``refractive`` are energy fractions in [0, 1]; ``ior`` is the index of
    refraction used by Snell's law.
    """

    __slots__ = (
        "color",
        "diffuse",
        "specular",
        "reflective",
        "refractive",
        "ior",
        "texture",
    )

    def __init__(
        self,
        color: Vec3 = None,
        diffuse: float = 1.0,
        specular: float = 0.0,
        reflective: float = 0.0,
        refractive: float = 0.0,
        ior: float = 1.0,
        texture: Optional[Texture] = None,
    ):
        self.color = color if color is not None else Vec3(1, 1, 1)
        self.diffuse = float(diffuse)
        self.specular = float(specular)
        self.reflective = float(reflective)
        self.refractive = float(refractive)
        self.ior = float(ior)
        self.texture = texture


class HitRecord:
    """Mutable intersection out-parameter (reference: ``core/material.py:51-58``)."""

    __slots__ = ("t", "point", "normal", "material", "u", "v")

    def __init__(self):
        self.t = float("inf")
        self.point = None
        self.normal = None
        self.material = None
        self.u = 0.0
        self.v = 0.0
