"""Scene descriptions of the benchmark's configurations, as plain numpy.

A configuration file (``configs/<name>.json``) holds its scene as data:
materials, textures (files of the repository, pinned by their sha256),
explicit objects (finite planes, spheres, triangles), generated meshes,
light samples and the camera.  :func:`describe` turns it into a
:class:`SceneData` of float64 arrays, the numbers both sides start from:
``program.py`` builds the program's scene objects from them and
``reference/`` builds its own tables from them.  Nothing here imports the
program or torch.

A mesh generator is named by ``kind``; ``icosphere_grid`` is the grid of
subdivided icospheres in the Cornell shell of BASELINE.json config 5
(the same vertices, float32, as the program's ``MeshSceneBuilder``).
"""
from __future__ import annotations

import hashlib
import math
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[1]

# a triangle without vertex UVs takes the reference renderer's defaults
DEFAULT_UV = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0))


class Material(NamedTuple):
    color: tuple
    diffuse: float
    specular: float
    reflective: float
    refractive: float
    ior: float
    texture: Optional[str]  # a key of SceneData.textures


class SceneData(NamedTuple):
    materials: Dict[str, Material]
    textures: Dict[str, Path]  # name -> file, checked against its sha256
    planes: List[dict]  # anchor, normal, u_dir, v_dir (float64 (3,)), u_len, v_len, material
    spheres: List[dict]  # center (3,), radius, material
    tri_v: np.ndarray  # (T, 3, 3) float64 vertices
    tri_uv: np.ndarray  # (T, 3, 2) float64 vertex UVs (defaults filled in)
    tri_has_uv: np.ndarray  # (T,) bool: the object gave its UVs
    tri_mat: List[str]  # (T,) material names
    lights: np.ndarray  # (L, 3) float64 point samples
    camera: dict  # lookfrom, lookat, vup, vfov


def sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def describe(scene: dict, root: Path = REPO) -> SceneData:
    """The :class:`SceneData` of a configuration's ``scene`` entry; raises
    when a texture file is missing or differs from its pinned hash."""
    textures = {}
    for name, t in scene.get("textures", {}).items():
        path = root / t["file"]
        if not path.is_file():
            raise FileNotFoundError(f"texture {name}: {path} is missing")
        if sha256(path) != t["sha256"]:
            raise ValueError(f"texture {name}: {path} differs from its pinned sha256")
        textures[name] = path
    materials = {n: Material(tuple(m["color"]), m["diffuse"], m["specular"], m["reflective"],
                             m["refractive"], m["ior"], m.get("texture"))
                 for n, m in scene["materials"].items()}
    planes, spheres, tris, uvs, has_uv, tri_mat = [], [], [], [], [], []
    for o in scene.get("objects", []):
        if o["material"] not in materials:
            raise KeyError(f"object names an unknown material {o['material']!r}")
        if o["type"] == "plane":
            planes.append({k: np.asarray(o[k], np.float64) for k in ("anchor", "normal", "u_dir", "v_dir")}
                          | {"u_len": float(o["u_len"]), "v_len": float(o["v_len"]),
                             "material": o["material"]})
        elif o["type"] == "sphere":
            spheres.append({"center": np.asarray(o["center"], np.float64),
                            "radius": float(o["radius"]), "material": o["material"]})
        elif o["type"] == "triangle":
            tris.append(np.asarray(o["v"], np.float64))
            given = o.get("uv") or [None] * 3
            has_uv.append(all(u is not None for u in given))
            uvs.append([DEFAULT_UV[i] if u is None else u for i, u in enumerate(given)])
            tri_mat.append(o["material"])
        else:
            raise ValueError(f"unknown object type {o['type']!r}")
    for mesh in scene.get("meshes", []):
        verts, mats = MESHES[mesh["kind"]](mesh)
        tris.extend(verts)
        uvs.extend([DEFAULT_UV] * len(verts))
        has_uv.extend([False] * len(verts))
        tri_mat.extend(mats)
    for m in tri_mat:
        if m not in materials:
            raise KeyError(f"mesh names an unknown material {m!r}")
    tri_v = np.asarray(tris, np.float64).reshape(-1, 3, 3)
    return SceneData(materials, textures, planes, spheres, tri_v,
                     np.asarray(uvs, np.float64).reshape(-1, 3, 2), np.asarray(has_uv, bool),
                     tri_mat, np.asarray(scene["lights"], np.float64).reshape(-1, 3),
                     dict(scene["camera"]))


# ---- mesh generators ------------------------------------------------------------
def icosphere(subdivisions: int):
    """Unit icosphere ``(vertices (V, 3) float32, faces (F, 3))``: the
    icosahedron, each face split in four ``subdivisions`` times, new
    vertices pushed onto the sphere (in float64, then rounded)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                      [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                     dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                      [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                      [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                      [8, 6, 7], [9, 8, 1]], dtype=np.int64)
    for _ in range(subdivisions):
        vlist = list(verts)
        cache = {}

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k not in cache:
                m = (verts[a] + verts[b]) / 2.0
                m /= np.linalg.norm(m)
                cache[k] = len(vlist)
                vlist.append(m)
            return cache[k]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, dtype=np.int64)
    return verts.astype(np.float32), faces


def icosphere_grid(spec: dict):
    """A ``grid × grid`` array of icospheres on the floor of a ``box`` shell:
    radius ``radius_share`` of the spacing, raised ``lift`` plus ``step``
    times the sphere's index mod 3, materials taken in turn.  Vertices are
    float32, as the scene builder makes them."""
    verts, faces = icosphere(int(spec["subdivisions"]))
    grid, box = int(spec["grid"]), float(spec["box"])
    h = box / 2.0
    spacing = box / (grid + 1)
    radius = spacing * float(spec["radius_share"])
    mats = spec["materials"]
    out, names, k = [], [], 0
    for gx in range(grid):
        for gz in range(grid):
            cx = -h + spacing * (gx + 1)
            cz = -h + spacing * (gz + 1)
            cy = -h + radius + float(spec["lift"]) + float(spec["step"]) * ((gx * grid + gz) % 3)
            world = verts * radius + np.array([cx, cy, cz], dtype=np.float32)
            out.append(world[faces].astype(np.float64))
            names += [mats[k % len(mats)]] * len(faces)
            k += 1
    return np.concatenate(out), names


MESHES = {"icosphere_grid": icosphere_grid}


# ---- camera ---------------------------------------------------------------------
def _unit(v: np.ndarray) -> np.ndarray:
    n = math.sqrt(float(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]))
    return np.zeros(3) if n == 0.0 else v * (1.0 / n)


def camera12(camera: dict, aspect: float) -> np.ndarray:
    """The pinhole camera as 12 float32: origin, lower-left corner,
    horizontal and vertical spans of the image plane at distance 1."""
    origin = np.asarray(camera["lookfrom"], np.float64)
    half_h = math.tan(math.radians(camera["vfov"]) / 2.0)
    half_w = aspect * half_h
    w = _unit(origin - np.asarray(camera["lookat"], np.float64))
    u = _unit(np.cross(np.asarray(camera["vup"], np.float64), w))
    v = np.cross(w, u)
    llc = origin - u * half_w - v * half_h - w
    return np.concatenate([origin, llc, u * (2.0 * half_w), v * (2.0 * half_h)]).astype(np.float32)
