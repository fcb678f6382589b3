"""CPU-parity Whitted renderer — port of the JAX package's
``models/whitted_oracle.py`` (reference ``cpu_raytracer``,
``renderers/cpu_renderer.py``), the slow physics oracle the GPU renderers
were compared against.

Physics (all from ``cpu_renderer.py:75-151``):

* ambient = ``diffuse · base · scene.ambient`` — the only renderer that reads
  the scene's ``ambient``/``light_color`` globals (SURVEY.md §2 quirk 12);
* per-light Lambert with **no distance falloff**, Phong with the reference's
  reflected light vector against the view vector, fixed shininess 32, and a
  shadow query bounded at the light's distance;
* the recursion **forks into both** reflection and refraction, mixed as
  ``local·(1−kr−kt) + kr·R + kt·T``; refracted rays always offset along −n
  (quirk), and both children are normalized.

The fork makes the cost grow as 2^depth, so depth is clamped to
``ORACLE_MAX_DEPTH`` (event ``depth_clamped``).  The scene is compiled with
the host conventions (plane ``v = n × u``, no GPU wire-format masking:
planes and triangles may refract, any primitive may be textured).

The JAX package lays the fork tree out as a heap of constant-width segments
(XLA needs static shapes).  Here the recursion runs level by level: each
level's nodes are only the lanes that forked into them, so empty nodes cost
nothing.  Every level is one closest-hit launch (``ops/cuda/intersect``,
K3a) and one any-hit launch for the shadow rays of all its nodes and all
light samples (K3b); the per-lane values are those of the heap.  On a BVH
scene the two queries are ``ops/intersect.scene_hit`` and
``scene_hit_any``, as in the JAX oracle: the BVH scene walks K4a and K4b,
or the two-level walk K6 on a paged tree.
"""
from __future__ import annotations

import math
from typing import List

import torch

from ..ops.cuda.intersect import any_hit, closest_hit
from ..ops.intersect import resolve_material, scene_hit, scene_hit_any
from ..ops.texture import resolve_base_color
from ..ops.v3 import V3, refract
from ..utils.logging import log_event
from .base import RendererFactory
from .wavefront import WavefrontRenderer
from .whitted import fold_cells, grid_camera_rays

_T_MIN = 1e-3
_T_FAR = 1e30  # the closest-hit bound of the reference's recursion
_EPS_OFFSET = 1e-3
# Fork depth cap (the JAX package's): fork chains beyond it carry < 0.85^12
# of a glass path's energy (QUIRKS.md).
ORACLE_MAX_DEPTH = 12
# deepest-level lane budget of the chunk plan (the JAX package's)
_LEVEL_LANE_BUDGET = 1 << 22


def surface(o: V3, d: V3, rec):
    """``(point, normal)`` of a closest-hit record; a miss takes the
    reference's normal ``(0, 1, 0)``."""
    one, zero = torch.ones_like(rec.t), torch.zeros_like(rec.t)
    return o + d * rec.t, V3.where(rec.hit, rec.normal, V3(zero, one, zero))


def shadow_rays(cs, point: V3, normal: V3):
    """The shadow rays of every light sample from every lane, light-major:
    ``(origin, direction, dist)``, each ``(L, m)``; the bound is ``dist``."""
    m = point.x.shape[0]
    lights = V3(*(c[:, None] for c in cs.lights))  # (L, 1) against (m,) lanes
    to_light_raw = lights - point
    origin = V3(*(c.expand(cs.n_lights, m) for c in point + normal * _EPS_OFFSET))
    return origin, to_light_raw.normalized(), to_light_raw.norm()


def _closest(cs, blob, o: V3, d: V3):
    """The closest hit of a level: K3a, or the BVH scene walk."""
    if cs.bvh is not None:
        return scene_hit(cs, o, d, _T_MIN, _T_FAR)
    return closest_hit(cs, blob, o, d, _T_MIN, _T_FAR)


def _occluded(cs, blob, o: V3, d: V3, dist):
    """Occlusion of shadow rays in ``(_T_MIN, dist)``: K3b, or the BVH
    scene walk."""
    if cs.bvh is not None:
        return scene_hit_any(cs, o, d, _T_MIN, dist)
    return any_hit(cs, blob, o, d, _T_MIN, dist)


def _shade_local(cs, blob, point: V3, normal: V3, base: V3, diffuse, specular,
                 ray_origin: V3) -> V3:
    """Ambient plus, per light sample, Lambert + Phong where unoccluded.
    The shadow rays of every light go out as one any-hit launch."""
    local = base * cs.ambient * diffuse
    n_lights = cs.n_lights
    if n_lights == 0:
        return local
    inv_n = 1.0 / n_lights
    shadow_org, ldir, dist = shadow_rays(cs, point, normal)
    occluded = _occluded(cs, blob, V3(*(c.reshape(-1) for c in shadow_org)),
                         V3(*(c.reshape(-1) for c in ldir)), dist.reshape(-1)).reshape(dist.shape)

    diff = torch.clamp(normal.dot(ldir), min=0.0)
    lambert = base * cs.light_color * (diffuse * diff * inv_n)
    # reference Phong: reflect the *light* vector (cpu_renderer.py:107-110)
    view = (ray_origin - point).normalized()
    spec = torch.clamp(view.dot(ldir.reflect(normal)), min=0.0)
    phong = cs.light_color * (specular * torch.pow(spec, 32.0) * inv_n)
    zero = torch.zeros_like(dist)
    lit = V3.where(~occluded, lambert + phong, V3(zero, zero, zero))
    acc = V3(*(torch.zeros_like(point.x) for _ in range(3)))
    for li in range(n_lights):  # the light loop's order
        acc = acc + V3(lit.x[li], lit.y[li], lit.z[li])
    return local + acc


def _trace(cs, blob, org: V3, rd: V3, max_depth: int) -> V3:
    """The reference's fork recursion, evaluated level by level.

    Level ``k`` holds the rays of every depth-``k`` node that some lane
    reached: the reflection children of the level above, then its
    refraction children.  Nodes of level ``max_depth`` fork no further.  The
    backward pass combines ``local·(1−kr−kt) + kr·R + kt·T`` from the deepest
    level up; a child that was never spawned, or missed, adds 0.
    """
    levels = []
    o, d = org, rd
    for level in range(max_depth + 1):
        rec = _closest(cs, blob, o, d)
        hit = rec.hit
        point, normal = surface(o, d, rec)
        (mcolor, diffuse, specular, reflective, refractive, ior, has_tex, tex_id) = (
            resolve_material(cs, rec.prim))
        base = resolve_base_color(cs, mcolor, has_tex, tex_id, rec.u, rec.v)
        local = _shade_local(cs, blob, point, normal, base, diffuse, specular, o)
        node = (local, reflective, refractive, hit)
        if level == max_depth:
            levels.append((*node, None, None))
            break
        # reflection branch (cpu_renderer.py:113-117); Ray() normalizes
        refl_dir = d.reflect(normal).normalized()
        refl_org = point + normal * _EPS_OFFSET
        # refraction branch (cpu_renderer.py:119-142)
        inside = d.dot(normal) > 0.0
        outward = V3.where(inside, -normal, normal)
        eta = torch.where(inside, ior, 1.0 / ior)
        ok, refr_dir = refract(d, outward, eta)
        # quirk: refracted rays always offset along −n, even when exiting
        branch_dir = V3.where(ok, refr_dir.normalized(), refl_dir)
        branch_org = V3.where(ok, point - normal * _EPS_OFFSET, refl_org)
        refl_sel = torch.nonzero(hit & (reflective > 0.0))[:, 0]
        refr_sel = torch.nonzero(hit & (refractive > 0.0))[:, 0]
        levels.append((*node, refl_sel, refr_sel))
        if refl_sel.numel() + refr_sel.numel() == 0:  # host sync
            break
        o = V3(*(torch.cat([a[refl_sel], b[refr_sel]]) for a, b in zip(refl_org, branch_org)))
        d = V3(*(torch.cat([a[refl_sel], b[refr_sel]]) for a, b in zip(refl_dir, branch_dir)))

    below = None  # colours of the level under the current one
    for local, kr, kt, lane, refl_sel, refr_sel in reversed(levels):
        zero = torch.zeros_like(kr)
        refl = V3(zero, zero, zero)
        refr = V3(zero, zero, zero)
        if below is not None:
            k = refl_sel.numel()
            refl = V3(*(z.index_put((refl_sel,), c[:k]) for z, c in zip(refl, below)))
            refr = V3(*(z.index_put((refr_sel,), c[k:]) for z, c in zip(refr, below)))
        c = local * (1.0 - kr - kt) + refl * kr + refr * kt
        below = V3.where(lane, c, V3(zero, zero, zero))
    return below


class CPUParityRayTracer(WavefrontRenderer):
    """Registered as ``cpu_raytracer``: the reference oracle's physics,
    executed as tensor ops on the renderer's device."""

    convention = "cpu"
    gpu_parity = False

    def __init__(self, **kw):
        # the reference CPU sampler draws two independent uniforms
        # (cpu_renderer.py:49-50): no du == dv quirk here
        kw.setdefault("jitter", "independent")
        super().__init__("cpu_raytracer", **kw)

    def get_capabilities(self) -> List[str]:
        return ["ray_tracing", "shadows", "reflection", "refraction", "area_lights",
                "anti_aliasing", "bvh_acceleration"]

    def _samples_per_group(self, spp: int) -> int:
        return max(1, math.isqrt(spp) ** 2)

    def _chunk_rays(self, max_depth, group):
        # bound the lanes of the deepest level: shrink the pixel chunk by depth
        depth = min(max_depth, ORACLE_MAX_DEPTH)
        if depth < max_depth:
            log_event("depth_clamped", requested=max_depth, effective=depth)
        budget_rays = max(1024, _LEVEL_LANE_BUDGET >> depth) * max(group, 1)
        return min(self.chunk_rays, budget_rays)

    def _chunk(self, cs, cam12, sums, pix0, seed, sample_base, *, n_pix, width, height,
               n_samples, max_depth, spp, col0):
        depth = min(max_depth, ORACLE_MAX_DEPTH)
        o, d = grid_camera_rays(cam12, pix0, n_pix, width, height, seed, sample_base,
                                n_samples, math.isqrt(spp), depth, self.jitter)
        blob = None if cs.bvh is not None else self.blobs(cs)[0]  # K3's scene blob
        fold_cells(sums, col0, n_pix, _trace(cs, blob, o, d, depth))

    def device_sums(self, scene, camera, settings, sample_offset=0, n_samples=None):
        # one indivisible grid group, as the Whitted renderers
        return super().device_sums(scene, camera, settings, sample_offset=0,
                                   n_samples=self._samples_per_group(settings.samples_per_pixel))

    def _finalize_dev(self, sums, spp_total: int, settings):
        # the same ⌊√spp⌋²-sum / requested-spp division as the reference
        # (cpu_renderer.py:40,58)
        return sums / float(spp_total)


RendererFactory.register("cpu_raytracer", CPUParityRayTracer)
