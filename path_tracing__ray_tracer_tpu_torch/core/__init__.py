"""Host-side scene description layer (API parity with the reference ``core/``)."""

from .acceleration import BVHNode
from .camera import Camera
from .geometry import Hittable, Plane, Sphere, Triangle
from .material import HitRecord, Material, Texture
from .math import AABB, Ray, Vec3
from .scene import CameraParams, RenderSettings, Scene, create_area_light

__all__ = [
    "AABB",
    "BVHNode",
    "Camera",
    "CameraParams",
    "HitRecord",
    "Hittable",
    "Material",
    "Plane",
    "Ray",
    "RenderSettings",
    "Scene",
    "Sphere",
    "Texture",
    "Triangle",
    "Vec3",
    "create_area_light",
]
