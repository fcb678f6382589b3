"""Wavefront Whitted ray tracers — port of the JAX package's
``models/whitted.py`` (reference ``cuda_raytracer``,
``renderers/cuda_renderer.py``, and ``cuda_texture_raytracer``,
``renderers/cuda_texture_renderer.py``, the CLI default that produced
``output_RayTracer.png``).

Each bounce is one launch of the CUDA kernel ``ops/cuda/whitted.whitted_bounce``
(its plain torch version on the CPU): closest hit, the 16 shadow sweeps and
Lambert/Phong shading, the energy factor and the reflect/refract
continuation.  A BVH scene takes the plain bounce ``whitted_bounce_plain``
instead, whose ``scene_hit`` and ``scene_hit_any`` launch the BVH scene
kernels K4a and K4b on the card (as the JAX package declines its SMEM sweep
kernel for big scenes).  Between bounces plain torch ops resolve the base
colour and apply ``color += atten · (base · a + w)``; the carried
attenuation is a scalar per ray (reference semantics).

Quirks kept (SURVEY.md §2): hard-coded 0.4 ambient, the two falloff
variants, the shininess table, the ``max(0.1, 1−kr−kt)`` energy floor,
refraction on spheres only, the diagonal jitter (both jitter draws equal),
and the grid sampler that sums ⌊√spp⌋² cells but divides by the requested
spp.
"""
from __future__ import annotations

import math
from typing import List

import torch

from ..ops import rng
from ..ops.camera import generate_rays
from ..ops.cuda.whitted import BASIC, TEXTURE, WhittedVariant, whitted_bounce, whitted_bounce_plain
from ..ops.texture import resolve_base_color
from ..ops.v3 import V3
from .base import RendererFactory
from .wavefront import WavefrontRenderer, pixel_coords

__all__ = ["BASIC", "TEXTURE", "WhittedVariant", "whitted_radiance", "grid_camera_rays"]


def whitted_radiance(cs, blobs, org: V3, rd: V3, max_depth: int, variant: WhittedVariant) -> V3:
    """Trace one batch of rays to completion, returning radiance.

    Equal per lane to the JAX package's ``whitted_radiance``: a lane adds
    ``atten · (base · a + w)`` at every bounce that hits, and continues only
    while the material reflects or refracts and ``depth < max_depth − 1``.
    After each bounce the batch is compacted to the lanes that continue (one
    host sync per bounce), so dead lanes cost the kernel nothing, and the
    loop ends as soon as none is left.
    """
    n = int(org.x.shape[0])
    color = torch.zeros((3, n), dtype=torch.float32, device=org.x.device)
    ids = None  # the rows of ``color`` that the batch's lanes add into (None: all, in order)
    o, d = org, rd
    atten = torch.ones(n, dtype=torch.float32, device=org.x.device)
    for depth in range(max_depth):
        if cs.bvh is None:
            out = whitted_bounce(cs, *blobs, o, d, variant)
        else:
            out = whitted_bounce_plain(cs, o, d, variant)
        base = resolve_base_color(cs, out.mat_color, (out.tex_id >= 0.0).to(torch.float32),
                                  out.tex_id.to(torch.int32), out.u, out.v)
        contrib = (base * out.a + V3(out.w, out.w, out.w)) * atten
        zero = torch.zeros_like(atten)
        add = torch.stack(tuple(V3.where(out.hit, contrib, V3(zero, zero, zero))))
        if ids is None:
            color += add
        else:
            color[:, ids] += add
        if depth == max_depth - 1:
            break
        sel = torch.nonzero(out.hit & out.cont)[:, 0]  # host sync
        if sel.numel() == 0:
            break
        atten = (atten * out.mult)[sel]
        o, d = out.new_org.take(sel), out.new_dir.take(sel)
        ids = sel if ids is None else ids[sel]
    return V3(*color)


def grid_camera_rays(cam12, pix0: int, n_pix: int, width: int, height: int, seed: int,
                     cell0: int, n_cells: int, grid_n: int, jitter_depth: int, jitter: str):
    """Camera rays of the grid sampler for cells ``[cell0, cell0 + n_cells)``
    of the ⌊√spp⌋² grid and pixels ``[pix0, pix0 + n_pix)``, cell-major:
    lane ``c · n_pix + p`` is cell ``cell0 + c`` of pixel ``pix0 + p``.

    Reproduces the reference sampler (``cuda_texture_renderer.py:39-63``):
    cell ``(a, b) = divmod(cell, grid_n)`` jittered by two draws at depth
    ``jitter_depth``, slots 0 and 1, of the ``(pixel, cell)`` stream;
    ``"diagonal"`` reuses the first draw for both (SURVEY.md §2 quirk 2).
    """
    dev = cam12.device
    idx, x, y = pixel_coords(pix0, n_pix, width, height, dev)
    cell = torch.arange(cell0, cell0 + n_cells, dtype=torch.int64, device=dev)[:, None]
    a = (cell // grid_n).to(torch.float32)
    b = (cell % grid_n).to(torch.float32)
    if jitter == "center":
        r1 = r2 = 0.5
    else:
        key = rng.ray_key(seed, idx[None, :], cell)
        r1 = rng.uniform(key, jitter_depth, 0)
        r2 = r1 if jitter == "diagonal" else rng.uniform(key, jitter_depth, 1)
    u = (x + (a + r1) / grid_n) / width
    v = (y + (b + r2) / grid_n) / height
    return generate_rays(cam12, u.reshape(-1), v.reshape(-1))


def fold_cells(sums: torch.Tensor, col0: int, n_pix: int, radiance: V3) -> None:
    """Add cell-major per-lane radiance into ``sums[:, col0:col0 + n_pix]``,
    one cell after the other (the JAX package's fold order)."""
    rad = torch.stack(tuple(radiance)).reshape(3, -1, n_pix)
    chunk = sums[:, col0:col0 + n_pix]
    for c in range(rad.shape[1]):
        chunk += rad[:, c]


class _WhittedBase(WavefrontRenderer):
    variant: WhittedVariant = BASIC

    def _samples_per_group(self, spp: int) -> int:
        # the grid sampler is indivisible: one group integrates all cells
        return max(1, math.isqrt(spp) ** 2)

    def _chunk(self, cs, cam12, sums, pix0, seed, sample_base, *, n_pix, width, height,
               n_samples, max_depth, spp, col0):
        # every cell of the chunk traces at once: n_samples * n_pix lanes.  The
        # grid is the frame's (a split hands out cells [sample_base, +n_samples)
        # of it, none past the grid's end)
        o, d = grid_camera_rays(cam12, pix0, n_pix, width, height, seed, sample_base,
                                n_samples, math.isqrt(spp), max_depth, self.jitter)
        rad = whitted_radiance(cs, self.blobs(cs), o, d, max_depth, self.variant)
        fold_cells(sums, col0, n_pix, rad)

    def device_sums(self, scene, camera, settings, sample_offset=0, n_samples=None):
        # a grid render is a single indivisible sample group
        return super().device_sums(scene, camera, settings, sample_offset=0,
                                   n_samples=self._samples_per_group(settings.samples_per_pixel))

    def _finalize_dev(self, sums, spp_total: int, settings):
        # faithful quirk: divide by the *requested* spp even though only
        # ⌊√spp⌋² samples were summed (cuda_renderer.py:39,64-66)
        return sums / float(spp_total)


class RayTracer(_WhittedBase):
    """``cuda_raytracer`` (alias ``tpu_raytracer``): reflection-only Whitted
    (``renderers/cuda_renderer.py``)."""

    variant = BASIC

    def __init__(self, **kw):
        super().__init__("cuda_raytracer", **kw)

    def get_capabilities(self) -> List[str]:
        return ["ray_tracing", "shadows", "reflection", "cuda_acceleration", "anti_aliasing"]


class TextureRayTracer(_WhittedBase):
    """``cuda_texture_raytracer`` (alias ``tpu_texture_raytracer``): textured
    Whitted with refraction (``renderers/cuda_texture_renderer.py``, the CLI
    default)."""

    variant = TEXTURE

    def __init__(self, **kw):
        super().__init__("cuda_texture_raytracer", **kw)

    def get_capabilities(self) -> List[str]:
        return ["ray_tracing", "shadows", "reflection", "refraction", "textures",
                "cuda_acceleration", "anti_aliasing", "all_geometry_types"]


RendererFactory.register("cuda_raytracer", RayTracer)
RendererFactory.register("cuda_texture_raytracer", TextureRayTracer)
RendererFactory.register_alias("tpu_raytracer", "cuda_raytracer")
RendererFactory.register_alias("tpu_texture_raytracer", "cuda_texture_raytracer")
