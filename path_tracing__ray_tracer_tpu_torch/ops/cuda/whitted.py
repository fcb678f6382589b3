"""One Whitted bounce: the CUDA kernel ``csrc/whitted_bounce.cu`` and its
plain torch version.

The kernel replaces the JAX package's
``ops/pallas/whitted_pallas.py::_whitted_bounce_kernel`` (entered there
through ``whitted_bounce_pallas``): the closest hit, the winner's material,
ambient plus one Lambert/Phong term per area-light sample with its shadow
sweep, the energy factor and the reflect/refract continuation.  It emits a
shading-weight record, not a colour: the base colour (atlas texel or
material colour) enters only as

    color += atten · (base · a + w)

with ``a`` the base-proportional terms (0.4 ambient, Lambert, the
metal-tinted specular) and ``w`` the white specular terms, both already
multiplied by the energy factor.

* :class:`WhittedVariant` holds the static physics switches of the two
  renderers (:data:`BASIC`, :data:`TEXTURE`).
* :func:`whitted_bounce` is the wrapper: a CUDA tensor always goes to the
  kernel (or the wrapper raises), a CPU tensor takes the plain version.
* :func:`whitted_bounce_plain` is the per-bounce body of the JAX package's
  XLA ``whitted_radiance`` (``models/whitted.py`` with ``_direct_lighting``),
  rearranged into the kernel's record and summed in the kernel's
  association, so that kernel and plain version compare tightly.

Both emit the kernel's convention on miss lanes (zero material, ior 1,
``tex_id`` −1); the caller reads only ``hit`` there.  Triangle UVs are always
interpolated.  The record does not depend on the bounce's depth, so depth is
not an input: the caller stops the continuation at ``max_depth``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..intersect import resolve_material, scene_hit, scene_hit_any
from ..v3 import V3
from .bounce import _check, _check_tables, sweep_plan
from .bvh import lane_counter, launch_grid, smem_limit

T_MIN = 1e-3
T_MAX = 1e6
_EPS = 1e-3
_AMBIENT = 0.4  # hard-coded GPU ambient (reference cuda_renderer.py:144)
_N_FIELDS = 17  # rows of the kernel's output record


class WhittedVariant(NamedTuple):
    """Static physics switches distinguishing the two Whitted renderers."""

    textured: bool  # sample the atlas for base colour
    refraction: bool  # spheres may refract
    falloff_scale: float  # 1.0 basic (cuda_renderer.py:195) / 1.5 texture (:277)
    diffuse_gain: float  # 1.0 basic / 0.6 texture (cuda_texture_renderer.py:281)
    spec_table: bool  # material-dependent shininess (cuda_texture_renderer.py:305-330)
    base_floor: bool  # max(0.1, 1-kr-kt) (texture :338) vs (1-kr) (basic :228)


BASIC = WhittedVariant(False, False, 1.0, 1.0, False, False)
TEXTURE = WhittedVariant(True, True, 1.5, 0.6, True, True)


class WhittedBounceOut(NamedTuple):
    hit: torch.Tensor  # bool
    a: torch.Tensor  # base-proportional shading weight (energy folded in)
    w: torch.Tensor  # white shading weight (energy folded in)
    cont: torch.Tensor  # bool: the ray continues (reflects or refracts)
    mult: torch.Tensor  # scalar attenuation multiplier of the continuation
    new_org: V3
    new_dir: V3
    u: torch.Tensor
    v: torch.Tensor
    tex_id: torch.Tensor  # float; < 0 when untextured
    mat_color: V3
    prim: torch.Tensor  # int32 winning global primitive id, -1 on miss


# ---- plain version -------------------------------------------------------------
def whitted_bounce_plain(cs, o: V3, d: V3, variant: WhittedVariant, t_min=T_MIN,
                         t_max=T_MAX) -> WhittedBounceOut:
    """One Whitted bounce for every ray, in plain torch ops."""
    hit = scene_hit(cs, o, d, t_min, t_max)
    h = hit.hit
    (mcolor, diffuse, specular, reflective, refractive, ior, has_tex, tex_id) = (
        resolve_material(cs, hit.prim))
    zero = torch.zeros_like(diffuse)
    mcolor = V3.where(h, mcolor, V3(zero, zero, zero))
    diffuse, specular, reflective, refractive, has_tex = (
        torch.where(h, f, zero) for f in (diffuse, specular, reflective, refractive, has_tex))
    ior = torch.where(h, ior, 1.0)
    n, p = hit.normal, hit.point

    # ---- ambient + area-light loop (cuda_texture_renderer.py:221-334) -------
    a = torch.full_like(zero, _AMBIENT)
    w = torch.zeros_like(zero)
    n_lights = cs.n_lights
    so = p + n * _EPS
    inv_l = 1.0 / max(n_lights, 1)
    for i in range(n_lights):
        tl = cs.lights.at_index(i) - p
        dist = tl.norm()
        near_ok = dist > 0.001
        ld = tl * (1.0 / torch.where(near_ok, dist, 1.0))
        lit = near_ok & ~scene_hit_any(cs, so, ld, t_min, dist - 0.001)

        diff = torch.clamp(n.dot(ld), min=0.0)
        atten = variant.falloff_scale / (1.0 + 0.001 * dist + 0.0001 * dist * dist)
        a = a + torch.where(lit, diff * atten * inv_l * diffuse * variant.diffuse_gain, 0.0)

        # Phong: R = 2(N·L)N − L against the view vector (−d)
        dot_nl = n.dot(ld)
        r = V3(2.0 * dot_nl * n.x - ld.x, 2.0 * dot_nl * n.y - ld.y, 2.0 * dot_nl * n.z - ld.z)
        dot_rv = torch.clamp(-(r.x * d.x + r.y * d.y + r.z * d.z), min=0.0)
        if variant.spec_table:
            chrome = (reflective > 0.9) & (specular > 0.9)
            metal = reflective > 0.7
            glossy = specular > 0.5
            shininess = torch.where(chrome, 256.0, torch.where(
                metal, 128.0, torch.where(glossy, 64.0, 32.0)))
            multiplier = torch.where(chrome, 1.5, torch.where(metal, 1.2, 1.0))
            gate = (specular > 0.01) & (diff > 0.0) & lit
            spec_int = torch.where(
                gate, torch.pow(dot_rv, shininess) * atten * multiplier * inv_l, 0.0) * specular
            a = a + torch.where(metal, spec_int, 0.0)  # tinted by base
            w = w + torch.where(metal, 0.0, spec_int)  # white highlight
        else:
            gate = (specular > 0.01) & lit
            w = w + torch.where(gate, torch.pow(dot_rv, 32.0) * specular * atten * inv_l, 0.0)

    # ---- energy factor + continuation (cuda_texture_renderer.py:336-423) ----
    if variant.base_floor:
        energy = torch.clamp(1.0 - reflective - refractive, min=0.1)
    else:
        energy = 1.0 - reflective
    a = a * energy
    w = w * energy

    dn = d.dot(n)
    refl = V3(d.x - 2.0 * dn * n.x, d.y - 2.0 * dn * n.y, d.z - 2.0 * dn * n.z)
    if variant.refraction:
        want = (reflective > 0.01) | (refractive > 0.01)
        use_refr = (refractive > reflective) & (refractive > 0.1)
        inside = dn > 0.0
        on = V3.where(inside, -n, n)
        eta = torch.where(inside, ior, 1.0 / ior)
        ci = -(d.x * on.x + d.y * on.y + d.z * on.z)
        sin2 = eta * eta * (1.0 - ci * ci)
        refr_ok = sin2 <= 1.0
        cth = torch.sqrt(torch.clamp(1.0 - sin2, min=0.0))
        fac = eta * ci - cth
        refr = V3(eta * d.x + fac * on.x, eta * d.y + fac * on.y, eta * d.z + fac * on.z)
        take = use_refr & refr_ok
        new_d = V3.where(take, refr, refl)
        # refraction offsets along +n when exiting, −n when entering (quirk)
        off = _EPS * torch.where(take, torch.where(inside, 1.0, -1.0), 1.0)
        new_o = p + n * off
        mult = torch.where(take, refractive * 0.95, reflective)
    else:
        want = reflective > 0.01
        new_d, new_o, mult = refl, p + n * _EPS, reflective

    tex = torch.where(has_tex > 0.5, tex_id.to(torch.float32), -1.0)
    if not variant.textured:
        tex = torch.full_like(tex, -1.0)
    return WhittedBounceOut(
        hit=h, a=a, w=w, cont=h & want, mult=mult, new_org=new_o, new_dir=new_d, u=hit.u,
        v=hit.v, tex_id=tex, mat_color=mcolor, prim=hit.prim,
    )


# ---- the kernel ------------------------------------------------------------------
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = ([_P, _I, _I, _I, _I, _P, _I, _P, _I] + [_P] * 6 + [_P, _P, _I, _F, _F]
             + [_I, _I, _F, _F, _I, _I] + [_P, _I, _I, _P])


def build():
    """Compile (once per source hash) and load ``csrc/whitted_bounce.cu``."""
    from . import build as _build

    built = _build.load("whitted_bounce")
    lib = built.lib
    lib.ptrt_whitted_bounce.argtypes = _ARGTYPES
    lib.ptrt_whitted_bounce_occupancy.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.ptrt_whitted_bounce, lib.ptrt_whitted_bounce_occupancy):
        fn.restype = ctypes.c_int
    return built


def _launch(cs, blob, mat_blob, light_blob, o: V3, d: V3, variant: WhittedVariant, t_min,
            t_max) -> WhittedBounceOut:
    who = "whitted_bounce"
    device = o.x.device
    n = int(o.x.shape[0])
    layout, n_mats, n_lights = _check_tables(who, cs, blob, mat_blob, light_blob, device)
    rays = (*o, *d)
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz"), rays):
        _check(name, t, torch.float32, n, device, who)
    plan = sweep_plan(who, layout[:4], n_mats, n_lights, smem_limit(device))

    out = torch.empty((_N_FIELDS, n), dtype=torch.float32, device=device)
    prim = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return _record(out, prim)
    lib = build().lib
    grid = launch_grid(who, lib.ptrt_whitted_bounce_occupancy, plan, n, device)
    err = lib.ptrt_whitted_bounce(
        blob.data_ptr(), layout.n_planes, layout.n_spheres, layout.n_quads, layout.n_tris,
        mat_blob.data_ptr(), n_mats, light_blob.data_ptr(), n_lights,
        *(t.data_ptr() for t in rays), out.data_ptr(), prim.data_ptr(), n, float(t_min),
        float(t_max), int(variant.textured), int(variant.refraction),
        float(variant.falloff_scale), float(variant.diffuse_gain), int(variant.spec_table),
        int(variant.base_floor), lane_counter(device).data_ptr(), plan.smem_bytes, grid,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed with cudaError {err}")
    whitted_bounce.launches += 1
    return _record(out, prim)


def _record(out, prim) -> WhittedBounceOut:
    return WhittedBounceOut(
        hit=out[0] > 0.5, a=out[1], w=out[2], cont=out[3] > 0.5, mult=out[4],
        new_org=V3(out[5], out[6], out[7]), new_dir=V3(out[8], out[9], out[10]), u=out[11],
        v=out[12], tex_id=out[13], mat_color=V3(out[14], out[15], out[16]), prim=prim,
    )


def whitted_bounce(cs, blob, mat_blob, light_blob, o: V3, d: V3, variant: WhittedVariant,
                   t_min=T_MIN, t_max=T_MAX) -> WhittedBounceOut:
    """One Whitted bounce for every ray.

    Rays on a CUDA device go to the kernel, which raises on anything it does
    not take; rays on the CPU take :func:`whitted_bounce_plain`.  ``blob``,
    ``mat_blob`` and ``light_blob`` are the packed tables of ``cs``
    (``ops/cuda/bounce.pack_scene_blob`` and friends), on the rays' device.
    """
    dev = o.x.device
    if dev.type == "cuda":
        return _launch(cs, blob, mat_blob, light_blob, o, d, variant, t_min, t_max)
    if dev.type == "cpu":
        return whitted_bounce_plain(cs, o, d, variant, t_min, t_max)
    raise ValueError(f"whitted_bounce: no kernel for device {dev}")


whitted_bounce.launches = 0  # kernel launches; the plain version does not count
