"""Scene intersection in plain torch ops: all rays against all primitives.

Port of the brute-force formulation of the JAX package's ``ops/intersect.py``
(its ``_closest_broadcast`` path): an ``(N, P)`` candidate matrix per
primitive type, concatenated in plane → sphere → quad → triangle order and
reduced with a first-occurrence ``argmin``, so ties resolve exactly like the
reference's sequential strict-``<`` scan.  Winner attributes (normal, UV) are
recomputed from the primitive tables after the reduction.

These ops are the plain version that the CUDA bounce kernels
(``ops/cuda/bounce.py``, ``ops/cuda/whitted.py``) are held against.

A scene with a flat BVH (``cs.bvh``) takes the JAX module's BVH branches:
the plane/sphere/quad broadcast with the triangles left out, the skip-link
walk of ``ops/bvh.py`` over the triangles, and the JAX combine.  On a CUDA
device ``scene_hit`` and ``scene_hit_any`` launch the BVH scene kernels
instead (``ops/cuda/bvh.py``, K4a and K4b); ``scene_hit_bvh_plain`` and
``scene_hit_any_bvh_plain`` are their plain versions.  A paged tree
(``cs.bvh.paged``) takes the two-level walk (``ops/cuda/bvh_paged.py``, K6),
whose plain versions are ``scene_hit_paged_plain`` and
``scene_hit_any_paged_plain``: the plane/sphere/quad result seeds the plain
top walk, then each lane's pending pages are walked with its carried best.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .bvh import leaf_attrs, paged_top, pages, traverse_any, traverse_closest
from .v3 import V3

EPS = 1e-6
_ALL = slice(None)


class SceneHit(NamedTuple):
    hit: torch.Tensor  # (N,) bool
    t: torch.Tensor  # (N,) f32
    point: V3  # (N,)
    normal: V3  # (N,) — quads/triangles flipped toward the ray
    u: torch.Tensor  # (N,)
    v: torch.Tensor  # (N,)
    prim: torch.Tensor  # (N,) int32 global primitive index, -1 on miss


class ClosestRecord(NamedTuple):
    """The closest-hit record the BVH kernels emit and carry from walk to
    walk: a triangle winner's raw barycentrics as ``u, v`` and its stored
    normal flipped toward the ray; another winner's surface UV and normal."""

    t: torch.Tensor  # (N,) f32, the bound on a miss
    prim: torch.Tensor  # (N,) int32, -1 on a miss
    u: torch.Tensor
    v: torch.Tensor
    normal: V3


def _plane_candidate(cs, i, ro: V3, rd: V3, t_min, best_t):
    """Finite-rectangle hit (``cuda_texture_renderer.py:445-521``): strict
    ``t_min < t < best_t``, inclusive ``0 <= u_hit <= u_len`` bounds."""
    n = cs.planes.normal.at_index(i)
    anchor = cs.planes.anchor.at_index(i)
    u_unit = cs.planes.u_unit.at_index(i)
    v_unit = cs.planes.v_unit.at_index(i)
    u_len = cs.planes.u_len[i]
    v_len = cs.planes.v_len[i]

    denom = rd.dot(n)
    nonparallel = torch.abs(denom) > EPS
    t = (anchor - ro).dot(n) / torch.where(nonparallel, denom, 1.0)
    rel = ro + rd * t - anchor
    u_hit = rel.dot(u_unit)
    v_hit = rel.dot(v_unit)
    valid = (
        nonparallel & (t > t_min) & (t < best_t)
        & (u_hit >= 0.0) & (u_hit <= u_len)
        & (v_hit >= 0.0) & (v_hit <= v_len)
    )
    return valid, t


def _sphere_candidate(cs, i, ro: V3, rd: V3, t_min, best_t):
    """Quadratic two-root selection (``cuda_texture_renderer.py:548-570``):
    near root if in range, else far root, both against the running best."""
    center = cs.spheres.center.at_index(i)
    radius = cs.spheres.radius[i]

    oc = ro - center
    a = rd.dot(rd)
    b = oc.dot(rd)
    c = oc.dot(oc) - radius * radius
    disc = b * b - a * c
    has_roots = disc > 0.0
    sqrt_d = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sqrt_d) / a
    t2 = (-b + sqrt_d) / a
    t1_ok = (t1 > t_min) & (t1 < best_t)
    t2_ok = (t2 > t_min) & (t2 < best_t)
    t = torch.where(t1_ok, t1, t2)
    chosen = torch.where(t1_ok, t1, torch.where(t2_ok, t2, -1.0))
    valid = has_roots & (t1_ok | t2_ok) & (chosen > 0.0)
    return valid, t


def _quad_candidate(cs, i, ro: V3, rd: V3, t_min, best_t):
    """Parallelogram quad: plane hit + two dual-basis dot products."""
    n = cs.quads.normal.at_index(i)
    origin = cs.quads.origin.at_index(i)
    du = cs.quads.du.at_index(i)
    dv = cs.quads.dv.at_index(i)

    denom = rd.dot(n)
    nonparallel = torch.abs(denom) > EPS
    t = (origin - ro).dot(n) / torch.where(nonparallel, denom, 1.0)
    rel = ro + rd * t - origin
    a = rel.dot(du)
    b = rel.dot(dv)
    valid = (
        nonparallel & (t > t_min) & (t < best_t)
        & (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    )
    return valid, t


def _triangle_candidate(cs, i, ro: V3, rd: V3, t_min, best_t):
    """Möller–Trumbore (``cuda_texture_renderer.py:636-677``)."""
    v0 = cs.triangles.v0.at_index(i)
    e1 = cs.triangles.v1.at_index(i) - v0
    e2 = cs.triangles.v2.at_index(i) - v0

    h = rd.cross(e2)
    det = e1.dot(h)
    nonparallel = torch.abs(det) > EPS
    inv_det = 1.0 / torch.where(nonparallel, det, 1.0)
    s = ro - v0
    u = inv_det * s.dot(h)
    q = s.cross(e1)
    v = inv_det * rd.dot(q)
    t = inv_det * e2.dot(q)
    valid = (
        nonparallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_min) & (t < best_t)
    )
    return valid, t


_CANDIDATES = (_plane_candidate, _sphere_candidate, _quad_candidate, _triangle_candidate)


def _lift(v: V3) -> V3:
    """(N,) SoA vector → (N, 1), so arithmetic against (P,) tables broadcasts."""
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


def _bound(t_max, n: int, like: torch.Tensor) -> torch.Tensor:
    """``t_max`` as an ``(n,)`` float32 bound on ``like``'s device; a
    scalar is filled there (no host copy, so a CUDA graph captures it)."""
    if isinstance(t_max, torch.Tensor):
        return t_max.to(dtype=torch.float32, device=like.device).expand(n)
    return torch.full((n,), float(t_max), dtype=torch.float32, device=like.device)


def _closest_broadcast(cs, ro: V3, rd: V3, t_min, t_max, include_tris: bool = True):
    n = ro.x.shape[0]
    ro1, rd1 = _lift(ro), _lift(rd)
    bound = _bound(t_max, n, ro.x)
    inf = float("inf")
    parts = []
    for cand in _CANDIDATES if include_tris else _CANDIDATES[:3]:
        valid, t = cand(cs, _ALL, ro1, rd1, t_min, bound[:, None])
        parts.append(torch.where(valid, t, inf))
    t_all = torch.cat(parts, dim=1)
    best_idx = torch.argmin(t_all, dim=1)
    best_t = torch.gather(t_all, 1, best_idx[:, None])[:, 0]
    hit = torch.isfinite(best_t)
    best_t = torch.where(hit, best_t, bound)
    return torch.where(hit, best_idx.to(torch.int32), -1), best_t, hit


def scene_hit(cs, ro: V3, rd: V3, t_min: float, t_max) -> SceneHit:
    """Closest hit of every ray against the whole scene (``t_max`` scalar or (N,)).

    Without a BVH, triangle UVs are always interpolated, as the CUDA kernels
    and the JAX package's Pallas sweep emit them (its XLA formulation leaves
    them 0 when no textured triangle reads them).  With one, the BVH scene
    kernel or :func:`scene_hit_bvh_plain` answers."""
    if cs.bvh is not None:
        from .cuda.bvh import scene_closest

        return scene_closest(cs, ro, rd, t_min, t_max)
    best_idx, best_t, hit = _closest_broadcast(cs, ro, rd, t_min, t_max)
    return _hit_record(cs, ro, rd, best_idx, best_t, hit, tri_uv=True)


def scene_hit_bvh_plain(cs, ro: V3, rd: V3, t_min: float, t_max, counts=None,
                        mxu: bool = False) -> SceneHit:
    """The JAX BVH branch of ``scene_hit``: the plane/sphere/quad broadcast,
    the skip-link walk over the triangles (``counts`` gathers its tests),
    the JAX combine; triangle UVs stay 0 when no textured triangle reads
    them.  ``mxu``: the leaves are tested by the leaf coefficient table,
    whose forms also give a triangle winner's barycentrics and normal (the
    plain version of K10a, the JAX MXU-leaf scene walk)."""
    P, S, Q = cs.n_planes, cs.n_spheres, cs.n_quads
    ps_idx, ps_t, ps_hit = _closest_broadcast(cs, ro, rd, t_min, t_max, include_tris=False)
    tri_t, tri_idx = traverse_closest(cs.bvh, cs.triangles, ro, rd, t_min, t_max,
                                      tri_offset=P + S + Q, counts=counts,
                                      leaf_mat=cs.bvh.leaf_mat if mxu else None)
    tri_hit = tri_idx >= 0
    tri_wins = tri_hit & (~ps_hit | (tri_t < ps_t))
    best_idx = torch.where(tri_wins, tri_idx, ps_idx)
    best_t = torch.where(tri_wins, tri_t, ps_t)
    attrs = leaf_attrs(cs.bvh, ro, rd, best_idx - (P + S + Q)) if mxu else None
    return _hit_record(cs, ro, rd, best_idx, best_t, ps_hit | tri_hit, tri_uv=tri_uv_read(cs),
                       tri_attrs=attrs)


def scene_hit_paged_plain(cs, ro: V3, rd: V3, t_min: float, t_max, counts=None) -> SceneHit:
    """The plain version of the paged route (K6a, then K6c): the
    plane/sphere/quad broadcast seeds the plain top walk, whose pending
    pages are then walked in increasing index with the carried best
    (``ops/bvh.paged_top`` and ``pages``); the record as
    ``scene_hit_bvh_plain`` builds it."""
    off = cs.n_planes + cs.n_spheres + cs.n_quads
    ps_idx, ps_t, _ = _closest_broadcast(cs, ro, rd, t_min, t_max, include_tris=False)
    best_t, best_i, plo, phi = paged_top(cs.bvh, cs.triangles, ro, rd, t_min, ps_t,
                                         best_i=ps_idx, tri_offset=off, counts=counts)
    best_t, best_i = pages(cs.bvh, cs.triangles, ro, rd, t_min, best_t, plo, phi, best_i=best_i,
                           tri_offset=off, counts=counts)
    return _hit_record(cs, ro, rd, best_i, best_t, best_i >= 0, tri_uv=tri_uv_read(cs))


def closest_record(cs, ro: V3, rd: V3, best_idx, best_t, tri_attrs=None) -> ClosestRecord:
    """The :class:`ClosestRecord` of the winners ``best_idx`` at ``best_t``,
    recomputed from the primitive tables (a triangle's barycentrics and
    stored normal from ``tri_attrs`` when given)."""
    h = _hit_record(cs, ro, rd, best_idx, best_t, best_idx >= 0, tri_uv=None, tri_attrs=tri_attrs)
    return ClosestRecord(h.t, h.prim, h.u, h.v, h.normal)


def tri_uv_read(cs) -> bool:
    """Does anything read triangle UVs (a textured triangle, or no flag)?"""
    return cs.tri_uv_used is None or bool(cs.tri_uv_used.shape[0])


def _hit_record(cs, ro: V3, rd: V3, best_idx, best_t, hit, tri_uv, tri_attrs=None) -> SceneHit:
    """The winners' attributes, recomputed from the primitive tables; a
    triangle winner's barycentrics and stored normal come from ``tri_attrs``
    ``(u, v, normal)`` when a walk kernel emitted them.  ``tri_uv``: True
    interpolates triangle UVs, False leaves them 0, None keeps the raw
    barycentrics (a :class:`ClosestRecord`)."""
    P, S, Q, T = cs.n_planes, cs.n_spheres, cs.n_quads, cs.n_triangles
    point = ro + rd * best_t

    is_plane = hit & (best_idx < P)
    is_sphere = hit & (best_idx >= P) & (best_idx < P + S)
    is_quad = hit & (best_idx >= P + S) & (best_idx < P + S + Q)
    is_tri = hit & (best_idx >= P + S + Q)

    bi = best_idx.long()
    pi = torch.clamp(bi, 0, P - 1)
    si = torch.clamp(bi - P, 0, S - 1)
    qi = torch.clamp(bi - P - S, 0, Q - 1)
    ti = torch.clamp(bi - P - S - Q, 0, T - 1)

    # plane attributes
    pn = cs.planes.normal.take(pi)
    rel = point - cs.planes.anchor.take(pi)
    p_u = rel.dot(cs.planes.u_unit.take(pi)) / cs.planes.u_len[pi]
    p_v = rel.dot(cs.planes.v_unit.take(pi)) / cs.planes.v_len[pi]

    # sphere attributes (UV fixed at 0 — reference quirk 3)
    s_rad = cs.spheres.radius[si]
    sn = (point - cs.spheres.center.take(si)) * (1.0 / torch.where(s_rad > 0, s_rad, 1.0))

    # quad attributes: dual-basis coordinates, normal flipped toward the ray
    q_rel = point - cs.quads.origin.take(qi)
    qa = q_rel.dot(cs.quads.du.take(qi))
    qb = q_rel.dot(cs.quads.dv.take(qi))
    qn_raw = cs.quads.normal.take(qi)
    qn = V3.where(qn_raw.dot(rd) > 0.0, -qn_raw, qn_raw)
    q_u = cs.quads.uv0[0][qi] + qa * cs.quads.uva[0][qi] + qb * cs.quads.uvb[0][qi]
    q_v = cs.quads.uv0[1][qi] + qa * cs.quads.uva[1][qi] + qb * cs.quads.uvb[1][qi]

    # triangle attributes: barycentrics from the kernel, or recomputed from
    # the winner's vertices
    if tri_attrs is not None:
        bu, bv, tn_raw = tri_attrs
    else:
        tv0 = cs.triangles.v0.take(ti)
        e1 = cs.triangles.v1.take(ti) - tv0
        e2 = cs.triangles.v2.take(ti) - tv0
        h = rd.cross(e2)
        det = e1.dot(h)
        inv_det = 1.0 / torch.where(torch.abs(det) > EPS, det, 1.0)
        s_vec = ro - tv0
        bu = inv_det * s_vec.dot(h)
        bv = inv_det * rd.dot(s_vec.cross(e1))
        tn_raw = cs.triangles.normal.take(ti)
    bw = 1.0 - bu - bv
    tn = V3.where(tn_raw.dot(rd) > 0.0, -tn_raw, tn_raw)
    tri = cs.triangles
    if tri_uv is None:  # the raw barycentrics
        t_u, t_v = bu, bv
    elif tri_uv:
        t_u = bu * tri.uv1[0][ti] + bv * tri.uv2[0][ti] + bw * tri.uv0[0][ti]
        t_v = bu * tri.uv1[1][ti] + bv * tri.uv2[1][ti] + bw * tri.uv0[1][ti]
    else:  # nothing reads triangle UVs
        t_u = t_v = torch.zeros_like(bu)

    normal = V3.where(is_plane, pn, V3.where(is_sphere, sn, V3.where(is_quad, qn, tn)))
    u = torch.where(is_plane, p_u, torch.where(is_quad, q_u, torch.where(is_tri, t_u, 0.0)))
    v = torch.where(is_plane, p_v, torch.where(is_quad, q_v, torch.where(is_tri, t_v, 0.0)))
    # miss default normal matches the reference's (0, 1, 0)
    zero, one = torch.zeros_like(u), torch.ones_like(u)
    normal = V3.where(hit, normal, V3(zero, one, zero))
    return SceneHit(hit=hit, t=best_t, point=point, normal=normal, u=u, v=v, prim=best_idx)


def scene_hit_any(cs, ro: V3, rd: V3, t_min: float, t_max) -> torch.Tensor:
    """Existence-only occlusion query for shadow rays with per-ray ``t_max``.

    With a BVH the BVH scene kernel or :func:`scene_hit_any_bvh_plain`
    answers; the kernel reports lanes with ``t_max <= 0`` (don't-care lanes)
    as occluded, the plain version as not: callers mask them."""
    if cs.bvh is not None:
        from .cuda.bvh import scene_any

        return scene_any(cs, ro, rd, t_min, t_max)
    return _ps_any(cs, ro, rd, t_min, t_max, _CANDIDATES)


def _ps_any(cs, ro: V3, rd: V3, t_min, t_max, candidates) -> torch.Tensor:
    n = ro.x.shape[0]
    ro1, rd1 = _lift(ro), _lift(rd)
    bound = _bound(t_max, n, ro.x)[:, None]
    occluded = torch.zeros(n, dtype=torch.bool, device=ro.x.device)
    for cand in candidates:
        valid, _ = cand(cs, _ALL, ro1, rd1, t_min, bound)
        occluded = occluded | torch.any(valid, dim=1)
    return occluded


def scene_hit_any_bvh_plain(cs, ro: V3, rd: V3, t_min: float, t_max, counts=None,
                            mxu: bool = False):
    """The JAX BVH branch of ``scene_hit_any``: the plane/sphere/quad
    broadcast, then the skip-link occlusion walk over the triangles (by the
    leaf coefficient table with ``mxu``: K10b's plain version)."""
    return _ps_any(cs, ro, rd, t_min, t_max, _CANDIDATES[:3]) | traverse_any(
        cs.bvh, cs.triangles, ro, rd, t_min, t_max, counts=counts,
        leaf_mat=cs.bvh.leaf_mat if mxu else None)


def scene_hit_any_paged_plain(cs, ro: V3, rd: V3, t_min: float, t_max, counts=None):
    """The plain version of the paged occlusion route (K6b, then K6d): the
    plane/sphere/quad broadcast, the plain top walk of the lanes it leaves
    unoccluded, then their pending pages up to the first hit."""
    found = _ps_any(cs, ro, rd, t_min, t_max, _CANDIDATES[:3])
    found, plo, phi = paged_top(cs.bvh, cs.triangles, ro, rd, t_min, t_max, any_hit=True,
                                found=found, counts=counts)
    return pages(cs.bvh, cs.triangles, ro, rd, t_min, t_max, plo, phi, any_hit=True,
                 found=found, counts=counts)


def resolve_material(cs, prim_idx: torch.Tensor):
    """The winner's material record through the unique-material table
    (``compiler`` builds it for ≤ 128 distinct materials), else straight from
    the per-primitive table.  Plain indexing; miss lanes (``prim < 0``) read
    primitive 0, as in the JAX package."""
    idx = torch.clamp(prim_idx, min=0).long()
    if cs.mat_table is None:
        m = cs.materials
    else:
        m = cs.mat_table
        idx = cs.mat_uid[idx].long()
    return (m.color.take(idx), m.diffuse[idx], m.specular[idx], m.reflective[idx],
            m.refractive[idx], m.ior[idx], m.has_tex[idx], m.tex_id[idx])
