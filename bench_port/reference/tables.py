"""The reference's scene tables, worked out from a configuration's
description (``bench_port/scenes.py``), not taken from the program.

Geometry follows the reference renderer's GPU wire format: a plane's normal
and both in-plane axes normalized from the given vectors; every triangle
kept as a triangle with its face normal ``normalize((v1-v0) x (v2-v0))``
(derived in float64, then rounded), its edges taken in the float type;
a triangle without UVs takes (0,0), (1,0), (1,1).  Materials per
primitive: planes and triangles carry no refraction (ior 1), planes and
spheres no texture.  Textures are decoded from their files with PIL.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scenes import SceneData
from .vec import V


class Tables(NamedTuple):
    device: torch.device
    dtype: torch.dtype
    n_planes: int
    n_spheres: int
    n_tris: int
    n_lights: int
    plane_anchor: V
    plane_normal: V
    plane_u: V
    plane_v: V
    plane_ulen: torch.Tensor
    plane_vlen: torch.Tensor
    sphere_center: V
    sphere_radius: torch.Tensor
    tri_v0: V
    tri_e1: V
    tri_e2: V
    tri_normal: V
    tri_uv: tuple  # three vertices' (u, v) tensors
    lights: V
    mat_of: torch.Tensor  # (P + S + T,) material row of each primitive
    mat_color: V
    mat_diffuse: torch.Tensor
    mat_reflective: torch.Tensor
    mat_refractive: torch.Tensor
    mat_ior: torch.Tensor
    mat_tex: torch.Tensor  # int64 texture row, -1 when untextured
    texels: torch.Tensor  # (n, 3) uint8, every texture's rows in turn
    tex_off: torch.Tensor
    tex_w: torch.Tensor
    tex_h: torch.Tensor


def _unit64(v: np.ndarray) -> np.ndarray:
    """Rows of ``v`` scaled to unit length in float64 (zero rows stay zero)."""
    n = np.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])
    return np.where(n[..., None] > 0, v * (1.0 / np.where(n > 0, n, 1.0))[..., None], 0.0)


def build(sd: SceneData, device, dtype=torch.float32) -> Tables:
    """The tables of ``sd`` on ``device`` in float type ``dtype``."""
    from PIL import Image

    dev = torch.device(device)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dtype)

    def v3(a):
        a = np.asarray(a, np.float64).reshape(-1, 3).astype(np.float32)
        return V(f(a[:, 0]), f(a[:, 1]), f(a[:, 2]))

    pl = sd.planes
    tri = sd.tri_v.astype(np.float32)
    t0, t1, t2 = (V(f(tri[:, k, 0]), f(tri[:, k, 1]), f(tri[:, k, 2])) for k in range(3))
    normal = _unit64(np.cross(sd.tri_v[:, 1] - sd.tri_v[:, 0], sd.tri_v[:, 2] - sd.tri_v[:, 0]))

    tex_names = sorted(sd.textures)
    tex_rows = {n: i for i, n in enumerate(tex_names)}
    pix, offs, ws, hs, at = [], [], [], [], 0
    for n in tex_names:
        with Image.open(sd.textures[n]) as img:
            a = np.asarray(img.convert("RGB"), dtype=np.uint8)
        pix.append(a.reshape(-1, 3))
        offs.append(at)
        hs.append(a.shape[0])
        ws.append(a.shape[1])
        at += a.shape[0] * a.shape[1]
    texels = np.concatenate(pix) if pix else np.full((1, 3), 255, np.uint8)

    # a material row per (material, refraction allowed, texture allowed)
    keys, mat_of = [], []

    def row(name, refract, texture):
        k = (name, refract, texture)
        if k not in keys:
            keys.append(k)
        return keys.index(k)

    mat_of += [row(p["material"], False, False) for p in pl]
    mat_of += [row(s["material"], True, False) for s in sd.spheres]
    mat_of += [row(m, False, True) for m in sd.tri_mat]
    recs = []
    for name, refract, texture in keys:
        m = sd.materials[name]
        tex = tex_rows[m.texture] if texture and m.texture is not None else -1
        recs.append((*m.color, m.diffuse, m.reflective, m.refractive if refract else 0.0,
                     m.ior if refract else 1.0, tex))
    recs = np.asarray(recs, np.float64).reshape(-1, 8)
    return Tables(
        device=dev, dtype=dtype, n_planes=len(pl), n_spheres=len(sd.spheres),
        n_tris=int(tri.shape[0]), n_lights=int(sd.lights.shape[0]),
        plane_anchor=v3([p["anchor"] for p in pl]),
        plane_normal=v3(_unit64(np.asarray([p["normal"] for p in pl]).reshape(-1, 3))),
        plane_u=v3(_unit64(np.asarray([p["u_dir"] for p in pl]).reshape(-1, 3))),
        plane_v=v3(_unit64(np.asarray([p["v_dir"] for p in pl]).reshape(-1, 3))),
        plane_ulen=f([p["u_len"] for p in pl]), plane_vlen=f([p["v_len"] for p in pl]),
        sphere_center=v3([s["center"] for s in sd.spheres]),
        sphere_radius=f([s["radius"] for s in sd.spheres]),
        tri_v0=t0, tri_e1=t1 - t0, tri_e2=t2 - t0, tri_normal=v3(normal),
        tri_uv=tuple((f(sd.tri_uv[:, k, 0]), f(sd.tri_uv[:, k, 1])) for k in range(3)),
        lights=v3(sd.lights),
        mat_of=torch.as_tensor(np.asarray(mat_of, np.int64), device=dev),
        mat_color=v3(recs[:, 0:3]), mat_diffuse=f(recs[:, 3]), mat_reflective=f(recs[:, 4]),
        mat_refractive=f(recs[:, 5]), mat_ior=f(recs[:, 6]),
        mat_tex=torch.as_tensor(recs[:, 7].astype(np.int64), device=dev),
        texels=torch.as_tensor(texels, device=dev),
        tex_off=torch.as_tensor(np.asarray(offs or [0], np.int64), device=dev),
        tex_w=torch.as_tensor(np.asarray(ws or [1], np.int64), device=dev),
        tex_h=torch.as_tensor(np.asarray(hs or [1], np.int64), device=dev),
    )
