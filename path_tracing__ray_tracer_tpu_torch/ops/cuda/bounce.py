"""One path-tracer bounce: the CUDA kernel ``csrc/path_bounce.cu`` and its
plain torch version.

The kernel replaces the JAX package's
``ops/pallas/bounce_pallas.py::_path_bounce_kernel`` (entered there through
``path_bounce_pallas``).  This module keeps what surrounds it:

* the scene packers ``pack_scene_blob`` / ``pack_mat_blob`` /
  ``pack_light_blob`` (the JAX package's wire format, flat), and
  ``pack_scene_rec16``, the primitive-major 16-byte records into which the
  K1, K2 and K7 blocks copy the blob's primitives in shared memory;
* ``sweep_plan``, the shared memory of a K1, K2 or K7 launch, and the grid
  of its persistent blocks (``ops/cuda/bvh.launch_grid``);
* the ``BounceOut`` shading-weight record, plus the winning primitive id;
* :func:`path_bounce`, the wrapper: a CUDA tensor always goes to the kernel
  (or the wrapper raises), a CPU tensor takes the plain version;
* :func:`path_bounce_plain`, the port of the JAX package's ``_bounce_xla``
  (``models/path_tracer.py``) built from the plain ops, which the CPU tests
  use and against which the kernel is checked on the card.

Both emit the kernel's convention on miss lanes: zero material, ior 1,
``tex_id`` −1.  The scheduler reads only ``hit``, ``killed`` and ``w_sky`` there.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import rng
from ..intersect import resolve_material, scene_hit, scene_hit_any
from ..sampling import cosine_hemisphere, pick_light
from ..v3 import V3, refract

T_MIN = 1e-3
T_MAX = 1e6
_EPS_OFFSET = 1e-3
_SKY = 0.1
# RNG "use" slots per bounce (JAX models/path_tracer.py)
_U_LIGHT, _U_RR, _U_EVENT, _U_HEMI1, _U_HEMI2 = 0, 1, 2, 3, 4
# glass event mixture (cuda_path_tracer.py:323-326)
_P_REFRACT, _P_REFLECT, _P_DIFFUSE = 0.6, 0.25, 0.15

_MAT_FIELDS = 10  # r g b diffuse specular reflective refractive ior has_tex tex_id
_N_FIELDS = 19  # rows of the kernel's output record
_SMEM_LIMIT = 48 * 1024  # shared memory of a block without an attribute (first designs)
# The record of each primitive type (csrc/sweep.cuh rec_layout): its fields
# in the blob's order, then zeros to a whole number of 16-byte records.
REC_FIELDS = (14, 4, 18, 18)  # plane, sphere, quad, triangle
REC_WIDTHS = (16, 4, 20, 20)


class BounceOut(NamedTuple):
    hit: torch.Tensor  # bool
    killed: torch.Tensor  # bool
    w_sky: torch.Tensor
    w_nee: torch.Tensor
    rr_scale: torch.Tensor
    s_thr: torch.Tensor
    t_thr: torch.Tensor
    new_org: V3
    new_dir: V3
    u: torch.Tensor
    v: torch.Tensor
    tex_id: torch.Tensor  # float; < 0 when untextured
    mat_color: V3
    prim: torch.Tensor  # int32 winning global primitive id, -1 on miss


# ---- scene packers -------------------------------------------------------------
class BlobLayout(NamedTuple):
    n_planes: int
    n_spheres: int
    n_quads: int
    n_tris: int
    plane_base: int
    sphere_base: int
    quad_base: int
    tri_base: int
    size: int


def blob_layout(cs) -> BlobLayout:
    P, S, Q, T = cs.n_planes, cs.n_spheres, cs.n_quads, cs.n_triangles
    pb = 0
    sb = pb + 14 * P  # anchor(3) normal(3) u_unit(3) v_unit(3) u_len v_len
    qb = sb + 4 * S  # center(3) radius
    tb = qb + 18 * Q  # origin(3) normal(3) du(3) dv(3) uv0(2) uva(2) uvb(2)
    return BlobLayout(P, S, Q, T, pb, sb, qb, tb, tb + 18 * T)  # v0 e1 e2 normal uv0-2


def _ps_parts(cs):
    p, s, q = cs.planes, cs.spheres, cs.quads
    return [
        *p.anchor, *p.normal, *p.u_unit, *p.v_unit, p.u_len, p.v_len,
        *s.center, s.radius,
        *q.origin, *q.normal, *q.du, *q.dv, *q.uv0, *q.uva, *q.uvb,
    ]


def pack_scene_blob(cs) -> torch.Tensor:
    """The primitive tables as one flat float32 blob, per-field contiguous:
    field ``f`` of primitive ``i`` at ``base + f·count + i``."""
    t = cs.triangles
    e1 = t.v1 - t.v0
    e2 = t.v2 - t.v0
    parts = _ps_parts(cs) + [*t.v0, *e1, *e2, *t.normal, *t.uv0, *t.uv1, *t.uv2]
    return torch.cat(parts).contiguous()


class RecLayout(NamedTuple):
    bases: tuple  # each type's first record, in floats (multiples of 4)
    size: int  # floats of all records


def rec_layout(counts) -> RecLayout:
    """The records' layout for the primitive ``counts`` (P, S, Q, T)."""
    bases, at = [], 0
    for count, width in zip(counts, REC_WIDTHS):
        bases.append(at)
        at += width * count
    return RecLayout(tuple(bases), at)


def pack_scene_rec16(cs) -> torch.Tensor:
    """The primitive tables as primitive-major records: primitive ``i`` of a
    type at ``base + width·i``, its fields in ``pack_scene_blob``'s order,
    then zeros to the type's width (16 floats a plane, 4 a sphere, 20 a quad
    or triangle), so each record is whole 16-byte rows.  The plain version
    of the copy each K1, K2 and K7 block makes into its shared memory
    (``csrc/sweep.cuh`` stage_records)."""
    layout, blob = blob_layout(cs), pack_scene_blob(cs)
    bases = (layout.plane_base, layout.sphere_base, layout.quad_base, layout.tri_base)
    parts = []
    for count, base, fields, width in zip(layout[:4], bases, REC_FIELDS, REC_WIDTHS):
        table = blob[base:base + fields * count].view(fields, count).T
        parts.append(torch.cat([table, table.new_zeros((count, width - fields))], 1).reshape(-1))
    return torch.cat(parts).contiguous()


class SweepPlan(NamedTuple):
    smem_bytes: int  # dynamic shared memory: the records, materials and lights


def sweep_plan(who, counts, n_mats: int, n_lights: int, limit: int) -> SweepPlan:
    """The launch of K1, K2 or K7 on a scene of primitive ``counts`` with
    ``n_mats`` materials and ``n_lights`` light samples, or of K3a/K3b (no
    materials, no lights), on a card whose blocks may take ``limit`` bytes
    of dynamic shared memory (``ops/cuda/bvh.smem_limit``; none of these
    kernels has static shared memory): a pure function of these sizes.  The
    tables (``csrc/sweep.cuh`` table_floats): the records, the material
    table padded to whole float4s, 4 floats a light sample.  Raises when
    they do not fit."""
    mat = -(-_MAT_FIELDS * n_mats // 4) * 4
    smem = 4 * (rec_layout(counts).size + mat + 4 * n_lights)
    if smem > limit:
        raise ValueError(f"{who}: scene tables need {smem} B of shared memory, "
                         f"more than the kernel's {limit} B")
    return SweepPlan(smem)


def pack_ps_blob(cs) -> torch.Tensor:
    """The planes, spheres and quads only: the prefix of ``pack_scene_blob``
    that the BVH kernels sweep (their triangles are in the slot records)."""
    return torch.cat(_ps_parts(cs)).contiguous()


def pack_mat_blob(cs) -> torch.Tensor:
    m = cs.materials
    return torch.cat([
        *m.color, m.diffuse, m.specular, m.reflective, m.refractive, m.ior,
        m.has_tex, m.tex_id.to(torch.float32),
    ]).contiguous()


def pack_light_blob(cs) -> torch.Tensor:
    return torch.cat([*cs.lights]).contiguous()


# ---- plain version -------------------------------------------------------------
def path_bounce_plain(cs, o: V3, d: V3, thr: V3, key, depth, t_min=T_MIN, t_max=T_MAX,
                      shadow_light: bool = False) -> BounceOut:
    """One bounce in plain torch ops (port of the JAX ``_bounce_xla``).
    ``key`` holds int32 RNG key bits; ``depth`` may be per-lane."""
    n = o.x.shape
    depth = torch.as_tensor(depth, dtype=torch.int32, device=o.x.device).expand(n)
    hit = scene_hit(cs, o, d, t_min, t_max)
    h = hit.hit
    (mcolor, diffuse, _spec, reflective, refractive, ior, has_tex, tex_id) = (
        resolve_material(cs, hit.prim))
    # the kernel's convention on miss lanes: zero material, ior 1, untextured
    zero = torch.zeros_like(diffuse)
    mcolor = V3.where(h, mcolor, V3(zero, zero, zero))
    diffuse, reflective, refractive, has_tex = (
        torch.where(h, f, zero) for f in (diffuse, reflective, refractive, has_tex))
    ior = torch.where(h, ior, 1.0)
    normal = hit.normal
    point = hit.point
    above = point + normal * _EPS_OFFSET

    w_sky = torch.where(h, 0.0, _SKY)

    # ---- next-event estimation (every bounce, every material) --------------
    if cs.n_lights > 0:
        r_light = rng.uniform(key, depth, _U_LIGHT)
        ldir, dist, pdf = pick_light(cs, point, r_light)
        # reference quirk: t_max = 1e6 (occluders beyond the light still
        # shadow); shadow_light bounds the query at the sampled light point
        limit = dist - 1e-3 if shadow_light else t_max
        cos_theta = torch.clamp(ldir.dot(normal), min=0.0)
        # lanes whose NEE term is zero whatever the occlusion: limit -1
        care = h & (cos_theta > 0.0) & (diffuse > 0.0)
        limit = torch.where(care, limit, -1.0)
        occluded = scene_hit_any(cs, above, ldir, t_min, limit)
        is_glass_cls = refractive > 0.5
        is_mirror_cls = reflective > 0.7
        intensity = torch.where(is_glass_cls, 4.0, torch.where(is_mirror_cls, 2.5, 2.0))
        multiplier = torch.where(is_glass_cls, 0.6, torch.where(is_mirror_cls, 0.8, 1.0))
        w_nee = torch.where(h & ~occluded,
                            diffuse * cos_theta * intensity * multiplier / pdf, 0.0)
    else:
        w_nee = torch.zeros_like(w_sky)

    # ---- Russian roulette from depth >= 3 -----------------------------------
    survival = torch.clamp(thr.luminance(), min=0.1)
    rr_on = depth >= 3
    killed = rr_on & (rng.uniform(key, depth, _U_RR) > survival)
    rr_scale = torch.where(rr_on & ~killed, 1.0 / survival, 1.0)

    # ---- scatter event -------------------------------------------------------
    choice = rng.uniform(key, depth, _U_EVENT)
    r1 = rng.uniform(key, depth, _U_HEMI1)
    r2 = rng.uniform(key, depth, _U_HEMI2)

    refl_dir = d.reflect(normal)
    hemi_dir = cosine_hemisphere(normal, r1, r2)

    # glass refraction event (cuda_path_tracer.py:328-388)
    cos_i = torch.clamp(-d.dot(normal), min=0.0)
    entering = cos_i > 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    outward = V3.where(entering, normal, -normal)
    refr_ok, refr_dir = refract(d, outward, eta)
    refr_org = V3.where(entering, point - normal * _EPS_OFFSET, above)

    glass = refractive > 0.1
    mirror = ~glass & (reflective > 0.5)
    ev_refract = glass & (choice < _P_REFRACT)
    ev_reflect = glass & (choice >= _P_REFRACT) & (choice < _P_REFRACT + _P_REFLECT)
    ev_diffuse = glass & (choice >= _P_REFRACT + _P_REFLECT)

    new_d = V3.where(
        ev_refract,
        V3.where(refr_ok, refr_dir, refl_dir),  # TIR falls back to mirror
        V3.where(ev_reflect | mirror, refl_dir, hemi_dir),
    )
    new_o = V3.where(ev_refract, V3.where(refr_ok, refr_org, above), above)

    # throughput multiplier in (s + base·t) form (reference constants)
    s_thr = torch.where(ev_refract, torch.where(refr_ok, refractive / _P_REFRACT, 0.9), 0.0)
    t_thr = torch.where(
        ev_refract, 0.0,
        torch.where(ev_reflect, 0.9 / _P_REFLECT,
                    torch.where(ev_diffuse, diffuse * 3.0 / _P_DIFFUSE,
                                torch.where(mirror, reflective, diffuse))),
    )

    return BounceOut(
        hit=h, killed=killed, w_sky=w_sky, w_nee=w_nee, rr_scale=rr_scale,
        s_thr=s_thr, t_thr=t_thr, new_org=new_o, new_dir=new_d, u=hit.u, v=hit.v,
        tex_id=torch.where(has_tex > 0.5, tex_id.to(torch.float32), -1.0),
        mat_color=mcolor, prim=hit.prim,
    )


# ---- the kernel ------------------------------------------------------------------
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _I, _I, _I, _P, _I, _P, _I, _P] + [_P] * 9 + [
    _P, _P, _P, _I, ctypes.c_float, ctypes.c_float, _I, _P, _I, _I, _P]


def build():
    """Compile (once per source hash) and load ``csrc/path_bounce.cu``."""
    from . import build as _build

    built = _build.load("path_bounce")
    lib = built.lib
    lib.ptrt_path_bounce.argtypes = _ARGTYPES
    lib.ptrt_path_bounce_occupancy.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.ptrt_path_bounce, lib.ptrt_path_bounce_occupancy):
        fn.restype = ctypes.c_int
    return built


def _check(name, t, dtype, n, device, who="path_bounce"):
    """Raise unless ``t`` is a contiguous ``(n,)`` ``dtype`` tensor on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{who}: {name} must be a tensor, got {type(t).__name__}")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(
            f"{who}: {name} must be a contiguous ({n},) {dtype} tensor on {device}; "
            f"got {tuple(t.shape)} {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def _check_tables(who, cs, blob, mat_blob, light_blob, device):
    """Raise unless the packed tables are those of ``cs`` on ``device`` (the
    kernel plans its shared memory: ``sweep_plan``); returns ``(layout,
    n_mats, n_lights)``."""
    layout = blob_layout(cs)
    n_mats, n_lights = int(cs.materials.diffuse.shape[0]), cs.n_lights
    for name, t, size in (("blob", blob, layout.size), ("mat_blob", mat_blob, _MAT_FIELDS * n_mats),
                          ("light_blob", light_blob, 3 * n_lights)):
        _check(name, t, torch.float32, size, device, who)
    return layout, n_mats, n_lights


def _launch(cs, blob, mat_blob, light_blob, o: V3, d: V3, thr: V3, key, depth,
            t_min, t_max, shadow_light) -> BounceOut:
    device = o.x.device
    n = int(o.x.shape[0])
    if isinstance(depth, int):
        depth = torch.full((n,), depth, dtype=torch.int32, device=device)
    from .bvh import lane_counter, launch_grid, smem_limit

    who = "path_bounce"
    layout, n_mats, n_lights = _check_tables(who, cs, blob, mat_blob, light_blob, device)
    rays = (*o, *d, *thr)
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz", "tx", "ty", "tz"), rays):
        _check(name, t, torch.float32, n, device)
    _check("depth", depth, torch.int32, n, device)
    _check("key", key, torch.int32, n, device)
    plan = sweep_plan(who, layout[:4], n_mats, n_lights, smem_limit(device))

    out = torch.empty((_N_FIELDS, n), dtype=torch.float32, device=device)
    prim = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return _record(out, prim)
    lib = build().lib
    grid = launch_grid(who, lib.ptrt_path_bounce_occupancy, plan, n, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.ptrt_path_bounce(
        blob.data_ptr(), layout.n_planes, layout.n_spheres, layout.n_quads, layout.n_tris,
        mat_blob.data_ptr(), n_mats, light_blob.data_ptr(), n_lights, depth.data_ptr(),
        *(t.data_ptr() for t in rays), key.data_ptr(), out.data_ptr(), prim.data_ptr(), n,
        float(t_min), float(t_max), int(bool(shadow_light)), lane_counter(device).data_ptr(),
        plan.smem_bytes, grid, stream)
    if err != 0:
        raise RuntimeError(f"path_bounce: kernel launch failed with cudaError {err}")
    path_bounce.launches += 1
    return _record(out, prim)


def _record(out, prim) -> BounceOut:
    return BounceOut(
        hit=out[0] > 0.5, killed=out[1] > 0.5, w_sky=out[2], w_nee=out[3], rr_scale=out[4],
        s_thr=out[5], t_thr=out[6], new_org=V3(out[7], out[8], out[9]),
        new_dir=V3(out[10], out[11], out[12]), u=out[13], v=out[14], tex_id=out[15],
        mat_color=V3(out[16], out[17], out[18]), prim=prim,
    )


def path_bounce(cs, blob, mat_blob, light_blob, o: V3, d: V3, thr: V3, key, depth,
                t_min=T_MIN, t_max=T_MAX, shadow_light: bool = False) -> BounceOut:
    """One bounce for every ray (per-lane ``depth``, int32 ``key`` bits).

    Rays on a CUDA device go to the kernel, which raises on anything it does
    not take; rays on the CPU take :func:`path_bounce_plain`.  ``blob``,
    ``mat_blob`` and ``light_blob`` are the packed tables of ``cs``
    (``pack_scene_blob`` and friends), on the rays' device.
    """
    dev = o.x.device
    if dev.type == "cuda":
        return _launch(cs, blob, mat_blob, light_blob, o, d, thr, key, depth,
                       t_min, t_max, shadow_light)
    if dev.type == "cpu":
        return path_bounce_plain(cs, o, d, thr, key, depth, t_min, t_max, shadow_light)
    raise ValueError(f"path_bounce: no kernel for device {dev}")


path_bounce.launches = 0  # kernel launches; the plain version does not count
