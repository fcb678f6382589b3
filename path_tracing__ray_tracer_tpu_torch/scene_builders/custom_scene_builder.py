"""The measured Cornell-box scene (parity with reference
``scene_builders/custom_scene_builder.py``).

Recreates the author's physically measured 30×30×30 cm foam-board Cornell box
(reference ``README.md:16-17``): five walls, two stacked 5.6 cm Rubik's
cubes (first rotated 225°), a 27.5×22 cm canvas leaning at 112° against the
back wall, three r=3 spheres (glass right, mirror left, glass atop the cube
stack), and a 4×4 grid of point samples standing in for a 3×3 cm ceiling
light.  All dimensions/material constants are scene *data* taken from the
reference (``custom_scene_builder.py:13-28,73-215``); the construction code
is table-driven rather than a port.
"""
from __future__ import annotations

import math

import numpy as np

from ..core import (
    Camera,
    Material,
    Plane,
    Scene,
    Sphere,
    Texture,
    Triangle,
    Vec3,
    create_area_light,
)
from ..utils.assets import texture_path

BOX = 30.0  # interior box size, cm
CUBE = 5.6  # Rubik's cube edge, cm
CANVAS_W, CANVAS_H, CANVAS_DEPTH = 27.5, 22.0, 1.5
CANVAS_ANGLE_DEG = 112.0
LIGHT_SIZE = 3.0
BALL_RADIUS = 3.0

# quad face UVs shared by cube faces and the canvas
_UV00, _UV10, _UV11, _UV01 = (
    np.array([0, 0]),
    np.array([1, 0]),
    np.array([1, 1]),
    np.array([0, 1]),
)


class CustomSceneBuilder:
    """``build_scene() -> Scene`` and ``create_camera(aspect) -> Camera``
    (same public surface as the reference builder :30-71)."""

    def build_scene(self) -> Scene:
        scene = Scene()
        mats = self._materials()
        self._add_walls(scene, mats)
        self._add_rubiks_cubes(scene, mats)
        self._add_spheres(scene, mats)
        self._add_canvas(scene, mats)
        self._add_lighting(scene)
        scene.build_bvh()
        # reference lighting globals (custom_scene_builder.py:56-57)
        scene.light_color = Vec3(0.7, 0.7, 0.7)
        scene.ambient = Vec3(0.5, 0.5, 0.5)
        return scene

    def create_camera(self, aspect_ratio: float = 4.0 / 3.0) -> Camera:
        # iPhone 12 Pro landscape: 49.5° vertical FOV at 50 cm
        # (custom_scene_builder.py:61-71)
        return Camera(
            lookfrom=Vec3(0, 0, 50.0),
            lookat=Vec3(0, 0, 0),
            vup=Vec3(0, 1, 0),
            vfov=49.5,
            aspect=aspect_ratio,
        )

    # ------------------------------------------------------------------ -----
    def _materials(self) -> dict:
        cube_tex = {
            name: Texture(texture_path(f"{name}.jpg"))
            for name in ("blue", "green", "orange", "red", "white", "yellow")
        }
        canvas_tex = Texture(texture_path("meinsf.jpg"))

        wall = lambda r, g, b: Material(color=Vec3(r, g, b), diffuse=0.8, specular=0.1)
        cube = lambda r, g, b, name: Material(
            color=Vec3(r, g, b), diffuse=0.7, specular=0.4, reflective=0.0,
            texture=cube_tex[name],
        )
        return {
            # walls (custom_scene_builder.py:91-105)
            "floor": wall(0.9, 0.9, 0.9),
            "back": wall(0.9, 0.9, 0.9),
            "ceiling": wall(0.9, 0.9, 0.9),
            "left": wall(255 / 255, 105 / 255, 180 / 255),  # hot pink
            "right": wall(52 / 255, 157 / 255, 204 / 255),  # blue
            # Rubik's faces (:109-136)
            "cube_blue": cube(0.0, 0.2, 0.8, "blue"),
            "cube_green": cube(0.0, 0.6, 0.0, "green"),
            "cube_orange": cube(1.0, 0.4, 0.0, "orange"),
            "cube_red": cube(0.8, 0.0, 0.0, "red"),
            "cube_white": cube(0.9, 0.9, 0.9, "white"),
            "cube_yellow": cube(1.0, 0.9, 0.0, "yellow"),
            # canvas (:139-142)
            "canvas": Material(
                color=Vec3(0.9, 0.8, 0.6), diffuse=0.9, specular=0.1, texture=canvas_tex
            ),
            # spheres (:145-214)
            "sphere_red": Material(
                color=Vec3(1, 0, 0), diffuse=0.7, specular=0.5, reflective=0.1
            ),
            "sphere_metal": Material(
                color=Vec3(0.9, 0.9, 0.9), diffuse=0.05, specular=0.95, reflective=0.95
            ),
            "glass": Material(
                color=Vec3(0.95, 0.95, 0.95), diffuse=0.1, specular=0.9,
                reflective=0.1, refractive=0.85, ior=1.5,
            ),
            "crystal": Material(
                color=Vec3(0.9, 0.95, 1.0), diffuse=0.1, specular=0.3,
                reflective=0.1, refractive=0.8, ior=2.4,
            ),
            "water_sphere": Material(
                color=Vec3(0.8, 0.9, 1.0), diffuse=0.15, specular=0.4,
                reflective=0.05, refractive=0.8, ior=1.33,
            ),
        }

    def _add_walls(self, scene: Scene, mats: dict):
        """Five wall rectangles (custom_scene_builder.py:219-286): anchor,
        normal, u_dir, v_dir per wall; the open face (+Z) is the camera side."""
        h = BOX / 2.0
        walls = [
            # (anchor,          normal,        u_dir,           v_dir,         material)
            (Vec3(-h, -h, h), Vec3(0, 1, 0), Vec3(BOX, 0, 0), Vec3(0, 0, -BOX), "floor"),
            (Vec3(-h, -h, -h), Vec3(0, 0, 1), Vec3(BOX, 0, 0), Vec3(0, BOX, 0), "back"),
            (Vec3(-h, -h, h), Vec3(1, 0, 0), Vec3(0, 0, -BOX), Vec3(0, BOX, 0), "left"),
            (Vec3(h, -h, -h), Vec3(-1, 0, 0), Vec3(0, 0, BOX), Vec3(0, BOX, 0), "right"),
            (Vec3(-h, h, -h), Vec3(0, -1, 0), Vec3(BOX, 0, 0), Vec3(0, 0, BOX), "ceiling"),
        ]
        for anchor, normal, u_dir, v_dir, mat in walls:
            scene.add_object(
                Plane(anchor, normal, u_dir, v_dir, BOX, BOX, mats[mat])
            )

    def _add_rubiks_cubes(self, scene: Scene, mats: dict):
        floor_y = -BOX / 2.0
        half = CUBE / 2.0
        # cube 1 on the floor rotated 225°, cube 2 stacked on top, unrotated
        self._add_cube(scene, mats, Vec3(0, floor_y + half, 0), 225.0)
        self._add_cube(scene, mats, Vec3(0, floor_y + half + CUBE, 0), 0.0)

    def _add_cube(self, scene: Scene, mats: dict, center: Vec3, rot_y_deg: float):
        """One Rubik's cube: 6 textured faces × 2 triangles
        (face→material mapping per custom_scene_builder.py:348-355)."""
        h = CUBE / 2.0
        corners = [
            Vec3(-h, -h, h), Vec3(h, -h, h), Vec3(h, h, h), Vec3(-h, h, h),
            Vec3(-h, -h, -h), Vec3(h, -h, -h), Vec3(h, h, -h), Vec3(-h, h, -h),
        ]
        angle = math.radians(rot_y_deg)
        c, s = math.cos(angle), math.sin(angle)
        world = [
            center + Vec3(p.x * c - p.z * s, p.y, p.x * s + p.z * c) for p in corners
        ]
        faces = [
            ((0, 1, 2, 3), "cube_red"),  # +Z
            ((1, 5, 6, 2), "cube_blue"),  # +X
            ((3, 2, 6, 7), "cube_yellow"),  # +Y
            ((4, 5, 1, 0), "cube_white"),  # -Y
            ((4, 0, 3, 7), "cube_orange"),  # -X
            ((5, 4, 7, 6), "cube_green"),  # -Z
        ]
        for (i0, i1, i2, i3), mat in faces:
            m = mats[mat]
            scene.add_object(Triangle(world[i0], world[i1], world[i2], _UV00, _UV10, _UV11, m))
            scene.add_object(Triangle(world[i0], world[i2], world[i3], _UV00, _UV11, _UV01, m))

    def _add_spheres(self, scene: Scene, mats: dict):
        floor_y = -BOX / 2.0
        q = BOX / 4.0
        # glass on the floor right, mirror metal left (custom_scene_builder.py:374-386)
        scene.add_object(Sphere(Vec3(q, floor_y + BALL_RADIUS, q), BALL_RADIUS, mats["glass"]))
        scene.add_object(Sphere(Vec3(-q, floor_y + BALL_RADIUS, q), BALL_RADIUS, mats["sphere_metal"]))
        # glass resting on top of the two-cube stack (:388-408)
        stack_top_y = floor_y + 2.0 * CUBE
        scene.add_object(Sphere(Vec3(0, stack_top_y + BALL_RADIUS, 0), BALL_RADIUS, mats["glass"]))

    def _add_canvas(self, scene: Scene, mats: dict):
        """Canvas leaning at 112° against the back wall
        (custom_scene_builder.py:430-476)."""
        back_z = -BOX / 2.0
        floor_y = -BOX / 2.0
        bottom_y = floor_y + 0.5
        angle = math.radians(CANVAS_ANGLE_DEG)
        half_w = CANVAS_W / 2.0
        bottom_z = back_z + 6.5 * CANVAS_DEPTH
        top_z = bottom_z + CANVAS_H * math.cos(angle)
        top_y = bottom_y + CANVAS_H * math.sin(angle)

        bl = Vec3(-half_w, bottom_y, bottom_z)
        br = Vec3(half_w, bottom_y, bottom_z)
        tl = Vec3(-half_w, top_y, top_z)
        tr = Vec3(half_w, top_y, top_z)
        m = mats["canvas"]
        scene.add_object(Triangle(bl, br, tr, _UV00, _UV10, _UV11, m))
        scene.add_object(Triangle(bl, tr, tl, _UV00, _UV11, _UV01, m))

    def _add_lighting(self, scene: Scene):
        """4×4 point-sample grid 1 cm under the ceiling
        (custom_scene_builder.py:478-490)."""
        create_area_light(
            scene,
            center=Vec3(0, BOX / 2 - 1, 0),
            u_vec=Vec3(1, 0, 0),
            v_vec=Vec3(0, 0, 1),
            u_size=LIGHT_SIZE,
            v_size=LIGHT_SIZE,
            n_u=4,
            n_v=4,
        )
