"""Plain reference of the path tracer the benchmark measures.

The semantics of the reference renderer's Monte-Carlo path tracer
(``renderers/cuda_path_tracer.py`` of enginism/Path-Tracing__ray-tracer) with
the counter-hash RNG that fixes every random number as a pure function of
(seed, pixel, sample, depth, use): camera rays with independent jitter, next
event estimation towards one light sample a bounce, Russian roulette from
depth 3, the three-event glass model, mirrors and cosine-weighted diffuse
bounces, nearest-texel texture lookup with a V flip; each path's radiance is
the left fold of its bounces' contributions, and each pixel adds its samples
in ascending order.  The reference's wire-format quirks hold: planes and
triangles carry no refraction, planes and spheres no texture.

Written as one path per (pixel, sample) traced to its end, every ray tested
against every primitive (no acceleration structure, no quad merge, no
scheduling), in plain torch elementwise operations.  ``dtype`` sets the
float type of every computation (float32 is the configuration's; the
benchmark's control runs it in bfloat16).  It imports nothing of the
program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .rng import ray_key, uniform
from .tables import Tables
from .vec import V, pick

T_MIN, T_MAX = 1e-3, 1e6
EPS = 1e-6  # parallel-ray guard of the plane and triangle tests
OFFSET = 1e-3  # shadow and bounce origins leave the surface by this
SKY = 0.1
U_LIGHT, U_RR, U_EVENT, U_HEMI1, U_HEMI2 = 0, 1, 2, 3, 4  # RNG uses within a bounce
U_JITX, U_JITY = 0, 1  # RNG uses of the jitter, at depth max_depth
P_REFRACT, P_REFLECT, P_DIFFUSE = 0.6, 0.25, 0.15  # the glass event mixture
TWO_PI = 6.283185307179586
# rays tested at once against every triangle (bounds the (rays, triangles) temporaries)
PAIRS_PER_BLOCK = 1 << 24


# ---- intersection: every ray against every primitive -----------------------------
def _planes(tb: Tables, o: V, d: V, bound):
    """Finite rectangles: strict ``T_MIN < t < bound``, inclusive extents."""
    n, a = tb.plane_normal, tb.plane_anchor
    denom = d.dot(n)
    ok = torch.abs(denom) > EPS
    t = (a - o).dot(n) / torch.where(ok, denom, 1.0)
    rel = o + d * t - a
    pu, pv = rel.dot(tb.plane_u), rel.dot(tb.plane_v)
    return ok & (t > T_MIN) & (t < bound) & (pu >= 0.0) & (pu <= tb.plane_ulen) & \
        (pv >= 0.0) & (pv <= tb.plane_vlen), t


def _spheres(tb: Tables, o: V, d: V, bound):
    """The near root if it lies in range, else the far root."""
    oc = o - tb.sphere_center
    a, b = d.dot(d), oc.dot(d)
    c = oc.dot(oc) - tb.sphere_radius * tb.sphere_radius
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1, t2 = (-b - sq) / a, (-b + sq) / a
    ok1 = (t1 > T_MIN) & (t1 < bound)
    ok2 = (t2 > T_MIN) & (t2 < bound)
    t = torch.where(ok1, t1, t2)
    chosen = torch.where(ok1, t1, torch.where(ok2, t2, -1.0))
    return (disc > 0.0) & (ok1 | ok2) & (chosen > 0.0), t


def _triangles(v0: V, e1: V, e2: V, o: V, d: V, bound):
    """Möller–Trumbore: inside the triangle, strict ``T_MIN < t < bound``."""
    h = d.cross(e2)
    det = e1.dot(h)
    ok = torch.abs(det) > EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    s = o - v0
    u = inv * s.dot(h)
    q = s.cross(e1)
    v = inv * d.dot(q)
    t = inv * e2.dot(q)
    return ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN) & \
        (t < bound), t


def _tri_blocks(tb: Tables, n: int):
    """Row blocks of rays, so that a block's (rays, triangles) pairs stay
    under PAIRS_PER_BLOCK."""
    step = max(1, PAIRS_PER_BLOCK // max(tb.n_tris, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def closest(tb: Tables, o: V, d: V, bound: torch.Tensor):
    """``(hit, t, prim)``: the nearest hit in ``(T_MIN, bound)``; on equal
    ``t`` the first primitive in plane, sphere, triangle order wins."""
    n = o.x.shape[0]
    inf = torch.tensor(float("inf"), dtype=tb.dtype, device=o.x.device)
    best_t = torch.full((n,), float("inf"), dtype=tb.dtype, device=o.x.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.x.device)
    oc, dc, bc = o.col(), d.col(), bound[:, None]
    base = 0
    for count, test in ((tb.n_planes, lambda: _planes(tb, oc, dc, bc)),
                        (tb.n_spheres, lambda: _spheres(tb, oc, dc, bc))):
        if count:
            ok, t = test()
            t = torch.where(ok, t, inf)
            m, i = torch.min(t, dim=1)
            win = m < best_t
            best_t, best_i = torch.where(win, m, best_t), torch.where(win, base + i, best_i)
        base += count
    if tb.n_tris:
        for rows in _tri_blocks(tb, n):
            ok, t = _triangles(tb.tri_v0, tb.tri_e1, tb.tri_e2, oc.at(rows), dc.at(rows), bc[rows])
            t = torch.where(ok, t, inf)
            m, i = torch.min(t, dim=1)
            win = m < best_t[rows]
            best_t[rows] = torch.where(win, m, best_t[rows])
            best_i[rows] = torch.where(win, base + i, best_i[rows])
    return best_i >= 0, best_t, best_i


def occluded(tb: Tables, o: V, d: V, limit: torch.Tensor) -> torch.Tensor:
    """Does any primitive lie in ``(T_MIN, limit)`` along the ray?"""
    oc, dc, lc = o.col(), d.col(), limit[:, None]
    found = torch.zeros(o.x.shape[0], dtype=torch.bool, device=o.x.device)
    if tb.n_planes:
        found |= _planes(tb, oc, dc, lc)[0].any(dim=1)
    if tb.n_spheres:
        found |= _spheres(tb, oc, dc, lc)[0].any(dim=1)
    if tb.n_tris:
        for rows in _tri_blocks(tb, o.x.shape[0]):
            found[rows] |= _triangles(tb.tri_v0, tb.tri_e1, tb.tri_e2, oc.at(rows), dc.at(rows),
                                      lc[rows])[0].any(dim=1)
    return found


class Surface(NamedTuple):
    point: V
    normal: V
    u: torch.Tensor
    v: torch.Tensor


def surface(tb: Tables, o: V, d: V, hit, t, prim) -> Surface:
    """Point, normal (triangles' turned toward the ray) and texture UV of
    each hit, from its primitive's table row."""
    P, S = tb.n_planes, tb.n_spheres
    point = o + d * t
    zero = torch.zeros_like(t)
    is_plane, is_sphere = hit & (prim < P), hit & (prim >= P) & (prim < P + S)
    pi = torch.clamp(prim, 0, max(P - 1, 0))
    si = torch.clamp(prim - P, 0, max(S - 1, 0))
    ti = torch.clamp(prim - P - S, 0, max(tb.n_tris - 1, 0))
    normal = V(zero, zero + 1.0, zero)  # a miss's normal
    u = v = zero
    if P:
        normal = pick(is_plane, tb.plane_normal.at(pi), normal)
    if S:
        r = tb.sphere_radius[si]
        sn = (point - tb.sphere_center.at(si)) * (1.0 / torch.where(r > 0, r, 1.0))
        normal = pick(is_sphere, sn, normal)
    if tb.n_tris:
        is_tri = hit & (prim >= P + S)
        v0, e1, e2 = tb.tri_v0.at(ti), tb.tri_e1.at(ti), tb.tri_e2.at(ti)
        h = d.cross(e2)
        det = e1.dot(h)
        inv = 1.0 / torch.where(torch.abs(det) > EPS, det, 1.0)
        s = o - v0
        bu = inv * s.dot(h)
        bv = inv * d.dot(s.cross(e1))
        bw = 1.0 - bu - bv
        tn = tb.tri_normal.at(ti)
        tn = pick(tn.dot(d) > 0.0, -tn, tn)
        normal = pick(is_tri, tn, normal)
        uv = tb.tri_uv
        tu = bu * uv[1][0][ti] + bv * uv[2][0][ti] + bw * uv[0][0][ti]
        tv = bu * uv[1][1][ti] + bv * uv[2][1][ti] + bw * uv[0][1][ti]
        u, v = torch.where(is_tri, tu, u), torch.where(is_tri, tv, v)
    return Surface(point, normal, u, v)


def texel(tb: Tables, tex, u, v) -> V:
    """Nearest texel with a V flip of texture ``tex`` (>= 0) at ``(u, v)``."""
    k = torch.clamp(tex, min=0)
    w, h, off = tb.tex_w[k], tb.tex_h[k], tb.tex_off[k]
    iu = torch.minimum(torch.clamp((torch.clamp(u, 0.0, 1.0) * (w - 1).to(u.dtype)).to(torch.int32),
                                   min=0), w - 1)
    iv = torch.minimum(torch.clamp(((1.0 - torch.clamp(v, 0.0, 1.0)) * (h - 1).to(u.dtype))
                                   .to(torch.int32), min=0), h - 1)
    rgb = tb.texels[(off + iv * w + iu).long()]
    inv = 1.0 / 255.0
    return V(rgb[:, 0].to(u.dtype) * inv, rgb[:, 1].to(u.dtype) * inv, rgb[:, 2].to(u.dtype) * inv)


class Bounce(NamedTuple):
    hit: torch.Tensor
    live: torch.Tensor  # hit and not killed by the roulette
    contrib: V  # radiance this bounce adds, before the throughput
    w_sky: torch.Tensor
    w_nee: torch.Tensor
    base: V
    rr: torch.Tensor
    s_thr: torch.Tensor
    t_thr: torch.Tensor
    org: V
    dir: V


def bounce(tb: Tables, o: V, d: V, thr: V, key, depth: int, shadow_light: bool) -> Bounce:
    """One bounce of every path: what it adds, whether it goes on, where."""
    n = o.x.shape[0]
    dev, dt = o.x.device, tb.dtype
    hit, t, prim = closest(tb, o, d, torch.full((n,), T_MAX, dtype=dt, device=dev))
    srf = surface(tb, o, d, hit, t, prim)
    mi = tb.mat_of[torch.clamp(prim, min=0)]
    zero = torch.zeros(n, dtype=dt, device=dev)

    def field(table):
        return torch.where(hit, table[mi], zero)

    color = V(field(tb.mat_color.x), field(tb.mat_color.y), field(tb.mat_color.z))
    diffuse, reflective, refractive = field(tb.mat_diffuse), field(tb.mat_reflective), \
        field(tb.mat_refractive)
    ior = torch.where(hit, tb.mat_ior[mi], 1.0)
    tex = torch.where(hit, tb.mat_tex[mi], -1)
    normal, point = srf.normal, srf.point
    above = point + normal * OFFSET
    w_sky = torch.where(hit, 0.0, SKY).to(dt)

    # next-event estimation towards one light sample
    n_lights = tb.n_lights
    w_nee = zero
    if n_lights:
        li = torch.clamp((uniform(key, depth, U_LIGHT, dt) * n_lights).to(torch.int32),
                         max=n_lights - 1).long()
        to_light = tb.lights.at(li) - point
        dist = torch.sqrt(to_light.dot(to_light))
        ldir = to_light * (1.0 / torch.where(dist > 0.001, dist, 1.0))
        limit = dist - 1e-3 if shadow_light else torch.full_like(dist, T_MAX)
        cos = torch.clamp(ldir.dot(normal), min=0.0)
        care = hit & (cos > 0.0) & (diffuse > 0.0)
        blocked = torch.zeros(n, dtype=torch.bool, device=dev)
        idx = care.nonzero()[:, 0]
        if idx.numel():
            blocked[idx] = occluded(tb, above.at(idx), ldir.at(idx), limit[idx])
        glass_cls, mirror_cls = refractive > 0.5, reflective > 0.7
        intensity = torch.where(glass_cls, 4.0, torch.where(mirror_cls, 2.5, 2.0)).to(dt)
        mult = torch.where(glass_cls, 0.6, torch.where(mirror_cls, 0.8, 1.0)).to(dt)
        w_nee = torch.where(hit & ~blocked, diffuse * cos * intensity * mult / (1.0 / n_lights), 0.0)

    # Russian roulette from depth 3
    lum = 0.299 * thr.x + 0.587 * thr.y + 0.114 * thr.z
    survival = torch.clamp(lum, min=0.1)
    if depth >= 3:
        killed = uniform(key, depth, U_RR, dt) > survival
        rr = torch.where(killed, 1.0, 1.0 / survival)
    else:
        killed, rr = torch.zeros_like(hit), torch.ones_like(survival)

    # the scatter event
    choice = uniform(key, depth, U_EVENT, dt)
    r1, r2 = uniform(key, depth, U_HEMI1, dt), uniform(key, depth, U_HEMI2, dt)
    refl = d - normal * (2.0 * d.dot(normal))
    cos_t, sin_t = torch.sqrt(r1), torch.sqrt(torch.clamp(1.0 - r1, min=0.0))
    phi = TWO_PI * r2
    steep = torch.abs(normal.z) > 0.9
    tang = V(torch.where(steep, 1.0, zero), zero, torch.where(steep, zero, 1.0)).cross(normal).unit()
    bitang = normal.cross(tang)
    hemi = tang * (sin_t * torch.cos(phi)) + bitang * (sin_t * torch.sin(phi)) + normal * cos_t

    cos_i = torch.clamp(-d.dot(normal), min=0.0)
    entering = cos_i > 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    outward = pick(entering, normal, -normal)
    ci = -d.dot(outward)
    sin2 = eta * eta * (1.0 - ci * ci)
    refr_ok = sin2 <= 1.0
    refr = d * eta + outward * (eta * ci - torch.sqrt(torch.clamp(1.0 - sin2, min=0.0)))
    refr_org = pick(entering, point - normal * OFFSET, above)

    glass = refractive > 0.1
    mirror = ~glass & (reflective > 0.5)
    ev_refract = glass & (choice < P_REFRACT)
    ev_reflect = glass & (choice >= P_REFRACT) & (choice < P_REFRACT + P_REFLECT)
    ev_diffuse = glass & (choice >= P_REFRACT + P_REFLECT)
    new_d = pick(ev_refract, pick(refr_ok, refr, refl), pick(ev_reflect | mirror, refl, hemi))
    new_o = pick(ev_refract, pick(refr_ok, refr_org, above), above)
    s_thr = torch.where(ev_refract, torch.where(refr_ok, refractive / P_REFRACT, 0.9), 0.0).to(dt)
    t_thr = torch.where(ev_refract, 0.0, torch.where(
        ev_reflect, 0.9 / P_REFLECT,
        torch.where(ev_diffuse, diffuse * 3.0 / P_DIFFUSE, torch.where(mirror, reflective, diffuse))))
    t_thr = t_thr.to(dt)

    textured = tex >= 0
    base = color
    if bool(textured.any()):
        base = pick(textured, texel(tb, tex, srf.u, srf.v), color)
    contrib = thr * w_sky + thr * (base * w_nee)
    return Bounce(hit, hit & ~killed, contrib, w_sky, w_nee, base, rr, s_thr, t_thr, new_o, new_d)


def camera_rays(tb: Tables, cam: torch.Tensor, idx, key, width: int, height: int, max_depth: int):
    """Rays through pixel ``idx`` (rows counted from the bottom), jittered
    by two draws at depth ``max_depth``."""
    dt = tb.dtype
    x, y = (idx % width).to(dt), (idx // width).to(dt)
    r1, r2 = uniform(key, max_depth, U_JITX, dt), uniform(key, max_depth, U_JITY, dt)
    u, v = (x + r1) / width, (y + r2) / height
    origin, llc, hor, ver = (V(cam[i], cam[i + 1], cam[i + 2]) for i in (0, 3, 6, 9))
    d = (llc + hor * u + ver * v - origin).unit()
    o = V(*(c.expand(u.shape).contiguous() for c in origin))
    return o, d


def path_sums(tb: Tables, cam: np.ndarray, pixels: np.ndarray, seed: int, sample0: int,
              n_samples: int, *, width: int, height: int, max_depth: int,
              shadow_light: bool) -> np.ndarray:
    """Radiance sums ``(P, 3)`` float64 of the float type's values, of
    samples ``[sample0, sample0 + n_samples)`` of the pixels ``pixels``
    (flat indices, rows from the bottom) under ``seed``: each path traced to
    its end, each pixel's samples added in ascending order."""
    dev, dt = tb.device, tb.dtype
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    P = int(pix.shape[0])
    # lane j is sample j % n_samples of pixel j // n_samples
    idx = pix.repeat_interleave(n_samples)
    sample = torch.arange(n_samples, dtype=torch.int64, device=dev).repeat(P) + sample0
    key = ray_key(seed, idx, sample)
    o, d = camera_rays(tb, torch.as_tensor(cam, dtype=dt, device=dev), idx, key, width, height,
                       max_depth)
    n = int(idx.shape[0])
    one, zero = torch.ones(n, dtype=dt, device=dev), torch.zeros(n, dtype=dt, device=dev)
    thr, psum = V(one, one, one), V(zero, zero, zero)
    out = torch.zeros((3, n), dtype=dt, device=dev)
    lane = torch.arange(n, device=dev)
    for depth in range(max_depth):
        b = bounce(tb, o, d, thr, key, depth, shadow_light)
        psum = psum + b.contrib
        thr_new = thr * b.rr * (b.base * b.t_thr + V(b.s_thr, b.s_thr, b.s_thr))
        thr = pick(b.live, thr_new, thr)
        go = b.live & (torch.maximum(thr.x, torch.maximum(thr.y, thr.z)) >= 0.001) & \
            (depth + 1 < max_depth)
        done = ~go
        out[:, lane[done]] = torch.stack([psum.x[done], psum.y[done], psum.z[done]])
        keep = go.nonzero()[:, 0]
        if keep.numel() == 0:
            break
        lane, key = lane[keep], key[keep]
        o, d, thr, psum = b.org.at(keep), b.dir.at(keep), thr.at(keep), psum.at(keep)
    per = out.view(3, P, n_samples)
    sums = torch.zeros((3, P), dtype=dt, device=dev)
    for s in range(n_samples):  # ascending sample order
        sums = sums + per[:, :, s]
    return sums.T.to(torch.float64).cpu().numpy()


def render_pixels(tb: Tables, cam: np.ndarray, pixels, seed: int, sample0: int, n_samples: int,
                  *, width: int, height: int, max_depth: int, shadow_light: bool,
                  lanes_per_call: int = 1 << 18) -> np.ndarray:
    """:func:`path_sums` over ``pixels`` in blocks of about ``lanes_per_call``
    paths, so that any number of pixels fits."""
    pixels = np.asarray(pixels, np.int64)
    step = max(1, lanes_per_call // max(n_samples, 1))
    parts = [path_sums(tb, cam, pixels[i:i + step], seed, sample0, n_samples, width=width,
                       height=height, max_depth=max_depth, shadow_light=shadow_light)
             for i in range(0, len(pixels), step)]
    return np.concatenate(parts) if parts else np.zeros((0, 3))


def tonemap_u8(sums: np.ndarray, spp: int, dtype=torch.float32) -> np.ndarray:
    """Displayed uint8 channels of radiance sums over ``spp`` samples: the
    ACES filmic fit (Narkowicz) of the mean, ``int(c * 255)`` clamped."""
    x = torch.as_tensor(sums).to(dtype) / float(spp)
    y = (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14)
    return torch.clamp(torch.trunc(y * 255.0), 0.0, 255.0).to(torch.uint8).numpy()


def image_pixels(rows, cols, width: int, height: int) -> np.ndarray:
    """Flat pixel indices (rows from the bottom) of displayed image
    positions ``(rows, cols)`` (row 0 at the top)."""
    return (height - 1 - np.asarray(rows, np.int64)) * width + np.asarray(cols, np.int64)


