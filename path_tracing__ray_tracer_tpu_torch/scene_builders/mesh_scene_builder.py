"""Procedural triangle-mesh-heavy scene — the BVH stress configuration
(BASELINE.json config 5: "triangle-mesh-heavy scene stressing BVH
build/traversal").

The reference has no mesh scenes (its only scene is the 34-primitive Cornell
box), so this builder is new surface: a grid of subdivided icospheres (glass,
mirror and diffuse) inside the same 30 cm Cornell shell, thousands of
triangles total, exercising the flat-BVH path end to end.
"""
from __future__ import annotations

import numpy as np

from ..core import Camera, Material, Plane, Scene, Triangle, Vec3, create_area_light

_GOLDEN = (1.0 + 5.0**0.5) / 2.0


def icosphere(subdivisions: int = 2):
    """Unit icosphere: returns (vertices (V,3), faces (F,3)) numpy arrays."""
    t = _GOLDEN
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )

    for _ in range(subdivisions):
        vlist = [v for v in verts]
        midpoint_cache = {}

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k not in midpoint_cache:
                m = (verts[a] + verts[b]) / 2.0
                m /= np.linalg.norm(m)
                midpoint_cache[k] = len(vlist)
                vlist.append(m)
            return midpoint_cache[k]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, dtype=np.int64)

    return verts.astype(np.float32), faces


class MeshSceneBuilder:
    """``build_scene()`` / ``create_camera(aspect)`` — a 3×3 grid of
    icospheres (~2,880 triangles per sphere at 3 subdivisions × 9 spheres ≈
    11.5k triangles with the default settings)."""

    def __init__(self, grid: int = 3, subdivisions: int = 3):
        self.grid = grid
        self.subdivisions = subdivisions

    def create_camera(self, aspect_ratio: float = 16.0 / 9.0) -> Camera:
        return Camera(
            lookfrom=Vec3(0, 0, 50.0),
            lookat=Vec3(0, 0, 0),
            vup=Vec3(0, 1, 0),
            vfov=49.5,
            aspect=aspect_ratio,
        )

    def build_scene(self) -> Scene:
        scene = Scene()
        box = 30.0
        h = box / 2.0
        wall = lambda r, g, b: Material(color=Vec3(r, g, b), diffuse=0.8, specular=0.1)
        walls = [
            (Vec3(-h, -h, h), Vec3(0, 1, 0), Vec3(box, 0, 0), Vec3(0, 0, -box), wall(0.9, 0.9, 0.9)),
            (Vec3(-h, -h, -h), Vec3(0, 0, 1), Vec3(box, 0, 0), Vec3(0, box, 0), wall(0.9, 0.9, 0.9)),
            (Vec3(-h, -h, h), Vec3(1, 0, 0), Vec3(0, 0, -box), Vec3(0, box, 0), wall(1.0, 0.41, 0.71)),
            (Vec3(h, -h, -h), Vec3(-1, 0, 0), Vec3(0, 0, box), Vec3(0, box, 0), wall(0.2, 0.62, 0.8)),
            (Vec3(-h, h, -h), Vec3(0, -1, 0), Vec3(box, 0, 0), Vec3(0, 0, box), wall(0.9, 0.9, 0.9)),
        ]
        for anchor, normal, u_dir, v_dir, mat in walls:
            scene.add_object(Plane(anchor, normal, u_dir, v_dir, box, box, mat))

        materials = [
            Material(Vec3(0.95, 0.95, 0.95), diffuse=0.1, specular=0.9,
                     reflective=0.1, refractive=0.85, ior=1.5),  # glass
            Material(Vec3(0.9, 0.9, 0.9), diffuse=0.05, specular=0.95, reflective=0.95),  # mirror
            Material(Vec3(0.85, 0.3, 0.25), diffuse=0.8, specular=0.4),  # diffuse red
            Material(Vec3(0.3, 0.7, 0.35), diffuse=0.8, specular=0.4),  # diffuse green
            Material(Vec3(0.95, 0.8, 0.3), diffuse=0.8, specular=0.4),  # diffuse gold
        ]

        verts, faces = icosphere(self.subdivisions)
        spacing = box / (self.grid + 1)
        radius = spacing * 0.35
        floor_y = -h
        k = 0
        for gx in range(self.grid):
            for gz in range(self.grid):
                cx = -h + spacing * (gx + 1)
                cz = -h + spacing * (gz + 1)
                cy = floor_y + radius + 0.5 + 2.0 * ((gx * self.grid + gz) % 3)
                mat = materials[k % len(materials)]
                k += 1
                world = verts * radius + np.array([cx, cy, cz], dtype=np.float32)
                for a, b, c in faces:
                    scene.add_object(
                        Triangle(
                            Vec3(*world[a]), Vec3(*world[b]), Vec3(*world[c]),
                            material=mat,
                        )
                    )

        create_area_light(
            scene,
            center=Vec3(0, h - 1, 0),
            u_vec=Vec3(1, 0, 0),
            v_vec=Vec3(0, 0, 1),
            u_size=4.0,
            v_size=4.0,
            n_u=4,
            n_v=4,
        )
        scene.light_color = Vec3(0.7, 0.7, 0.7)
        scene.ambient = Vec3(0.5, 0.5, 0.5)
        return scene
