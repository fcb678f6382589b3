"""Whole-scene intersection of a BVH scene: the CUDA kernels
``csrc/bvh_scene.cu`` and their plain torch versions.

The kernels replace the JAX package's
``ops/pallas/bvh_pallas.py::_bvh4_scene_closest_kernel`` (K4a, entered there
through ``bvh_scene_closest_pallas``) and ``::_bvh4_scene_any_kernel`` (K4b,
``bvh_scene_any_pallas``).  ``ops/intersect.scene_hit`` and
``scene_hit_any`` call these wrappers for every scene with a BVH; on a CUDA
tensor they launch the kernel (or raise), on a CPU tensor they take the
plain versions ``ops/intersect.scene_hit_bvh_plain`` and
``scene_hit_any_bvh_plain``.

* :func:`scene_closest` returns the ``SceneHit`` of the plain version: the
  kernel emits t, prim, the shading normal and, for a triangle winner, its
  raw barycentrics, from which this wrapper interpolates the triangle's UVs
  where a textured triangle reads them (else 0), as the JAX package's
  ``_fused_scene_hit`` does.  A per-ray bound takes the JAX package's
  per-ray branch instead: the plane/sphere/quad broadcast, the triangle-only
  walk K4c (``ops/cuda/bvh_paged.pages_closest`` over the whole tree) seeded
  with the bound, and the strict-``<`` combine.
* :func:`scene_any` returns a bool occlusion mask for a per-ray (or scalar)
  bound; the kernel reports lanes whose bound is ≤ 0 as occluded (their
  answer is not needed; the plain version says not occluded).

A scene with a paged tree (``cs.bvh.paged``) takes the two-level walk K6 of
``ops/cuda/bvh_paged.py`` for a scalar bound and for occlusion, as the JAX
package does; its plain versions are ``scene_hit_paged_plain`` and
``scene_hit_any_paged_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from ..bvh import GID_TRI_MASK
from ..intersect import (
    ClosestRecord,
    SceneHit,
    _closest_broadcast,
    _hit_record,
    scene_hit_any_bvh_plain,
    scene_hit_any_paged_plain,
    scene_hit_bvh_plain,
    scene_hit_paged_plain,
    tri_uv_read,
)
from ..v3 import V3
from .bounce import _check

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_DEPTH4 = 32  # csrc/bvh_walk.cuh kMaxDepth4: the deepest BVH4 the walks take


def build():
    """Compile (once per source hash) and load ``csrc/bvh_scene.cu``."""
    from . import build as _build

    built = _build.load("bvh_scene")
    head = [_P, _I, _P, _P, _I, _I, _I] + [_P] * 6
    built.lib.ptrt_bvh_closest.argtypes = head + [_I, _I, _F, _F] + [_P] * 7 + [_P]
    built.lib.ptrt_bvh_any.argtypes = head + [_P, _I, _F, _P, _P]
    built.lib.ptrt_bvh_closest.restype = built.lib.ptrt_bvh_any.restype = ctypes.c_int
    return built


def tree_args(who, cs, device):
    """The walk's records as launch arguments ``(nodes, n_nodes, slots, ps,
    P, S, Q)``, after checking them against ``cs`` and the kernel's limits."""
    bvh = cs.bvh
    if bvh is None:
        raise ValueError(f"{who}: the scene has no BVH")
    if bvh.depth4 > MAX_DEPTH4:
        raise ValueError(f"{who}: the BVH4 is {bvh.depth4} deep; the kernel's stack takes "
                         f"at most {MAX_DEPTH4}")
    P, S, Q = cs.n_planes, cs.n_spheres, cs.n_quads
    n_nodes = bvh.nodes4.shape[0] // 32
    _check("nodes4", bvh.nodes4, torch.float32, 32 * n_nodes, device, who)
    _check("slot_rec", bvh.slot_rec, torch.float32, bvh.slot_rec.shape[0], device, who)
    _check("ps_blob", bvh.ps_blob, torch.float32, 14 * P + 4 * S + 18 * Q, device, who)
    return (bvh.nodes4.data_ptr(), n_nodes, bvh.slot_rec.data_ptr(), bvh.ps_blob.data_ptr(),
            P, S, Q)


def gid_mask(cs) -> int:
    """The kernels' mask of a slot gid's triangle bits: the low 17 when the
    gids carry unique-material ids, else every bit."""
    return GID_TRI_MASK if cs.bvh.uid_packed else -1


def _rays(who, ro: V3, rd: V3):
    n = int(ro.x.shape[0])
    rays = (*ro, *rd)
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz"), rays):
        _check(name, t, torch.float32, n, ro.x.device, who)
    return n, rays


def _raise_on(who, err):
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed with cudaError {err}")


def _fused_hit(cs, ro: V3, rd: V3, t, prim, u, v, normal: V3) -> SceneHit:
    """The ``SceneHit`` of a BVH kernel's record (triangle winners carry raw
    barycentrics in ``u, v``): the JAX package's ``_fused_scene_hit``."""
    hit = prim >= 0
    off = cs.n_planes + cs.n_spheres + cs.n_quads
    is_tri = prim >= off
    if tri_uv_read(cs):
        ti = torch.clamp(prim - off, 0, cs.n_triangles - 1).long()
        tri = cs.triangles
        bw = 1.0 - u - v
        t_u = u * tri.uv1[0][ti] + v * tri.uv2[0][ti] + bw * tri.uv0[0][ti]
        t_v = u * tri.uv1[1][ti] + v * tri.uv2[1][ti] + bw * tri.uv0[1][ti]
        u, v = torch.where(is_tri, t_u, u), torch.where(is_tri, t_v, v)
    else:  # nothing reads triangle UVs
        u, v = torch.where(is_tri, 0.0, u), torch.where(is_tri, 0.0, v)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    return SceneHit(hit=hit, t=t, point=ro + rd * t,
                    normal=V3.where(hit, normal, V3(zero, one, zero)), u=u, v=v, prim=prim)


def scene_closest(cs, ro: V3, rd: V3, t_min: float, t_max) -> SceneHit:
    """Closest hit of every ray in ``(t_min, t_max)`` on a BVH scene: K4a, or
    K6 on a paged tree, for a scalar ``t_max``; the per-ray branch (K4c) for
    a tensor one.  Rays on the CPU take the plain versions."""
    dev = ro.x.device
    per_ray = isinstance(t_max, torch.Tensor)
    paged = cs.bvh is not None and cs.bvh.paged is not None and not per_ray
    if dev.type == "cpu":
        if paged:
            return scene_hit_paged_plain(cs, ro, rd, t_min, t_max)
        return scene_hit_bvh_plain(cs, ro, rd, t_min, t_max)
    if dev.type != "cuda":
        raise ValueError(f"scene_closest: no kernel for device {dev}")
    from . import bvh_paged

    if paged:
        return bvh_paged.scene_closest_paged(cs, ro, rd, t_min, t_max)
    if per_ray:
        return _per_ray_closest(cs, ro, rd, t_min, t_max)
    who = "scene_closest"
    tree = tree_args(who, cs, dev)
    n, rays = _rays(who, ro, rd)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    t, u, v, nx, ny, nz = out
    err = build().lib.ptrt_bvh_closest(
        *tree, *(r.data_ptr() for r in rays), n, gid_mask(cs), float(t_min), float(t_max),
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), nx.data_ptr(), ny.data_ptr(),
        nz.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(who, err)
    scene_closest.launches += 1
    return _fused_hit(cs, ro, rd, t, prim, u, v, V3(nx, ny, nz))


def _per_ray_closest(cs, ro: V3, rd: V3, t_min: float, t_max: torch.Tensor) -> SceneHit:
    """The JAX ``scene_hit``'s per-ray-bound BVH branch on the card: the
    plane/sphere/quad broadcast, the triangle walk K4c seeded with the
    bound (raw barycentrics and stored normal out), the strict-``<``
    combine."""
    from . import bvh_paged

    n = ro.x.shape[0]
    bound = t_max.to(torch.float32).expand(n).contiguous()
    ps_idx, ps_t, ps_hit = _closest_broadcast(cs, ro, rd, t_min, bound, include_tris=False)
    zero = torch.zeros_like(bound)
    seed = ClosestRecord(bound, torch.full((n,), -1, dtype=torch.int32, device=bound.device),
                         zero, zero, V3(zero, zero, zero))
    tri = bvh_paged.pages_closest(cs, ro, rd, t_min, seed)
    tri_hit = tri.prim >= 0
    tri_wins = tri_hit & (~ps_hit | (tri.t < ps_t))
    return _hit_record(cs, ro, rd, torch.where(tri_wins, tri.prim, ps_idx),
                       torch.where(tri_wins, tri.t, ps_t), ps_hit | tri_hit,
                       tri_uv=tri_uv_read(cs), tri_attrs=(tri.u, tri.v, tri.normal))


def scene_any(cs, ro: V3, rd: V3, t_min: float, limit) -> torch.Tensor:
    """Bool mask: is anything hit in ``(t_min, limit)`` on a BVH scene (K4b,
    or K6 on a paged tree)?  ``limit`` is per ray, or a scalar that is
    broadcast.

    Rays on a CUDA device go to the kernels; rays on the CPU take
    ``scene_hit_any_bvh_plain`` or ``scene_hit_any_paged_plain``."""
    dev = ro.x.device
    paged = cs.bvh is not None and cs.bvh.paged is not None
    if dev.type == "cpu":
        if paged:
            return scene_hit_any_paged_plain(cs, ro, rd, t_min, limit)
        return scene_hit_any_bvh_plain(cs, ro, rd, t_min, limit)
    if dev.type != "cuda":
        raise ValueError(f"scene_any: no kernel for device {dev}")
    who = "scene_any"
    n = int(ro.x.shape[0])
    if not isinstance(limit, torch.Tensor):
        limit = torch.full((n,), float(limit), dtype=torch.float32, device=dev)
    if paged:
        from . import bvh_paged

        return bvh_paged.scene_any_paged(cs, ro, rd, t_min, limit)
    tree = tree_args(who, cs, dev)
    n, rays = _rays(who, ro, rd)
    _check("limit", limit, torch.float32, n, dev, who)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    err = build().lib.ptrt_bvh_any(*tree, *(r.data_ptr() for r in rays), limit.data_ptr(), n,
                                   float(t_min), occ.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(who, err)
    scene_any.launches += 1
    return occ


scene_closest.launches = 0  # kernel launches; the plain version does not count
scene_any.launches = 0
