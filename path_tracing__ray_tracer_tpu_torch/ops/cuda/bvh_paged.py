"""The two-level (paged) BVH walk: the CUDA kernels ``csrc/bvh_paged.cu``
(K6a-d, and K4c/K4d, the same page walks over the whole one-level tree) and
their plain torch versions.

The kernels replace the JAX package's
``ops/pallas/bvh_paged_pallas.py::_paged_top_closest_kernel`` (K6a),
``::_paged_top_any_kernel`` (K6b), ``::_page_closest_kernel`` (K6c) and
``::_page_any_kernel`` (K6d), and ``ops/pallas/bvh_pallas.py``'s
triangle-only BVH4 walks ``_bvh4_closest_attrs_kernel`` /
``_bvh4_closest_kernel`` (K4c) and ``_bvh4_any_kernel`` (K4d).  Each wrapper
launches its kernel on a CUDA tensor (or raises) and takes its plain version
(``*_plain``, the walks of ``ops/bvh.py``) on a CPU tensor; each counts its
launches.

* :func:`paged_top_closest` (K6a): the plane/sphere/quad sweep seeds the top
  walk; returns the :class:`~..intersect.ClosestRecord` so far and the
  pending-page words ``(plo, phi)``.
* :func:`paged_top_any` (K6b): occlusion by the planes/spheres/quads and the
  top tree; returns ``(found, plo, phi)``.
* :func:`pages_closest` (K6c): the record carried through each pending page
  in increasing index.  Without ``plo``/``phi`` the whole one-level tree is
  one page that every lane walks (K4c).
* :func:`pages_any` (K6d): the found mask carried through each pending page;
  without ``plo``/``phi`` the whole tree (K4d).
* :func:`scene_closest_paged` / :func:`scene_any_paged`: the paged route of
  ``scene_hit`` / ``scene_hit_any``, two launches per query.

All four are persistent walks, as K4b is: ``launch_grid`` launches the
resident blocks of 256 threads, whose warps take their lanes from
``lane_counter``.  The top walks (K6a, K6b) are designed as K1 and K7 are:
each warp's first 32 lanes come from its place in the grid (a grid that
spans all lanes touches no counter), and each resident block stages its
tables once, the planes, spheres and quads as 16-byte records and, when
:func:`top_plan` stages them (whenever they fit), the top tree's node records
(read as 16-byte loads) and the 13-float top slots (read float by float);
otherwise it reads those two from device memory in the same way.  Their
stack holds 3·class − 2 entries, the class from the top tree's depth.  The
page walks:
``ops/cuda/bvh.page_plan`` picks the variant (the stack's depth class, from
the page depth or the whole tree's; nothing staged); they read the node
records as 16-byte loads and the padded slot records,
``PagedBlobs.page_slot16`` (the whole tree: ``FlatBVH.slot16``).  Each
kernel gives its first design's bits on every lane (the top walks':
``experiments/torch_paged_top_first_design.py``).

``ops/cuda/bvh.py`` sends a paged scene here.
"""
from __future__ import annotations

import ctypes

import torch

from ..bvh import leaf_attrs, paged_top, pages, traverse_any, traverse_closest
from ..intersect import (
    _CANDIDATES,
    ClosestRecord,
    SceneHit,
    _closest_broadcast,
    _ps_any,
    closest_record,
)
from ..v3 import V3
from .bounce import _check, rec_layout
from .bvh import (MAX_DEPTH4, WalkPlan, _fused_hit, _on, _raise_on, _rays, depth_class, gid_mask,
                  lane_counter, launch_grid, page_plan, slot16_arg, smem_limit)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


_BOUND = {}  # library path -> the library whose entries' argument types are set


def build():
    """Compile (once per source hash) and load ``csrc/bvh_paged.cu``; its
    entries' argument types are set once per library, since every K6a-d
    call comes here and setting them takes longer on the host than a top
    walk on the card (PERF.md)."""
    from . import build as _build

    built = _build.load("bvh_paged")
    lib = built.lib
    if _BOUND.get(built.path) is lib:
        return built
    top = [_P, _I, _P, _I, _P, _I, _I, _I] + [_P] * 6
    top_walk = [_P, _I, _I, _I, _I, _P]  # counter, stage, depth class, smem, grid, stream
    lib.ptrt_paged_top_closest.argtypes = top + [_I, _I, _F, _F] + [_P] * 9 + top_walk
    lib.ptrt_paged_top_any.argtypes = top + [_P, _I, _F, _P, _P, _P] + top_walk
    walk = [_P, _I, _I, _P]  # counter, depth class, grid, stream
    lib.ptrt_pages_closest.argtypes = ([_P, _L, _P, _L, _P, _P, _I, _I, _I] + [_P] * 6 + [_P, _P]
                                       + [_P] * 7 + [_I, _F] + [_P] * 7 + walk)
    lib.ptrt_pages_any.argtypes = ([_P, _L, _P, _L, _I] + [_P] * 6 + [_P, _P, _P, _P, _I, _F, _P]
                                   + walk)
    occupancy = [_I] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.ptrt_paged_top_closest_occupancy.argtypes = occupancy
    lib.ptrt_paged_top_any_occupancy.argtypes = occupancy
    lib.ptrt_pages_closest_occupancy.argtypes = occupancy
    lib.ptrt_pages_any_occupancy.argtypes = occupancy
    for fn in (lib.ptrt_paged_top_closest, lib.ptrt_paged_top_any, lib.ptrt_pages_closest,
               lib.ptrt_pages_any, lib.ptrt_paged_top_closest_occupancy,
               lib.ptrt_paged_top_any_occupancy, lib.ptrt_pages_closest_occupancy,
               lib.ptrt_pages_any_occupancy):
        fn.restype = ctypes.c_int
    _BOUND[built.path] = lib
    return built


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _paged(who, cs):
    bvh = cs.bvh
    if bvh is None or bvh.paged is None:
        raise ValueError(f"{who}: the scene has no paged BVH")
    pg = bvh.paged
    deepest = max(pg.top_depth, pg.page_depth)
    if deepest > MAX_DEPTH4:
        raise ValueError(f"{who}: the paged BVH4 is {deepest} deep; the kernel's stack takes at "
                         f"most {MAX_DEPTH4}")
    return pg


def top_plan(counts, n_top: int, n_slots: int, top_depth: int, limit: int) -> WalkPlan:
    """The variant of the top walks (K6a, K6b) on a scene of ``counts``
    planes, spheres and quads and a top tree of ``n_top`` BVH4 nodes, depth
    ``top_depth``, over ``n_slots`` top slots, on a card whose blocks may
    take ``limit`` bytes of dynamic shared memory (``ops/cuda/bvh.smem_limit``):
    a pure function of these sizes.  Each block holds the primitive records
    (``csrc/sweep.cuh`` rec_layout; raises when they do not fit) and, staged
    whenever they fit beside them, the 128 B node records and the 52 B top
    slots after them; the stack's depth class is the top tree's."""
    rec = 4 * rec_layout((*counts, 0)).size
    if rec > limit:
        raise ValueError(f"top_plan: the primitive records need {rec} B of shared memory, "
                         f"more than the kernel's {limit} B")
    tables = 4 * (32 * n_top + 13 * n_slots)
    stage = rec + tables <= limit
    return WalkPlan(stage, depth_class(top_depth), rec + (tables if stage else 0))


def top_walk_plan(cs, limit: int) -> WalkPlan:
    """:func:`top_plan` of ``cs``'s paged tree."""
    pg = cs.bvh.paged
    return top_plan((cs.n_planes, cs.n_spheres, cs.n_quads), pg.top_tree.shape[0] // 32,
                    pg.top_slot.shape[0] // 13, pg.top_depth, limit)


_TOP_PLANS = {}  # (device index, the sizes top_plan reads) -> the top walks' plan


def _top_args(who, cs, device):
    """The top walk's launch arguments ``(top, n_top, top_slot, n_slots,
    ps, P, S, Q)`` and its plan (:func:`top_walk_plan` on ``device``, asked
    once per device and sizes).  Both tables are copied as 16-byte loads,
    so each must start 16-byte aligned."""
    pg = _paged(who, cs)
    P, S, Q = cs.n_planes, cs.n_spheres, cs.n_quads
    n_top = pg.top_tree.shape[0] // 32
    n_slots = pg.top_slot.shape[0] // 13
    _check("top_tree", pg.top_tree, torch.float32, 32 * n_top, device, who)
    _check("top_slot", pg.top_slot, torch.float32, 13 * n_slots, device, who)
    if pg.top_tree.data_ptr() % 16 or pg.top_slot.data_ptr() % 16:
        raise ValueError(f"{who}: top_tree and top_slot must be 16-byte aligned")
    _check("ps_blob", cs.bvh.ps_blob, torch.float32, 14 * P + 4 * S + 18 * Q, device, who)
    key = (device.index, P, S, Q, n_top, n_slots, pg.top_depth)
    if key not in _TOP_PLANS:
        _TOP_PLANS[key] = top_walk_plan(cs, smem_limit(device))
    return ((pg.top_tree.data_ptr(), n_top, pg.top_slot.data_ptr(), n_slots,
             cs.bvh.ps_blob.data_ptr(), P, S, Q), _TOP_PLANS[key])


def _top_launch(who, occupancy, plan, n, dev):
    """The trailing launch arguments of a top walk: the lane counter, the
    plan's fields, the grid and the stream."""
    grid = launch_grid(who, occupancy, plan, n, dev)
    return (lane_counter(dev).data_ptr(), int(plan.stage), plan.depth_class, plan.smem_bytes,
            grid, _stream(dev))


def _check_2d(who, name, t, rows, device):
    if (not isinstance(t, torch.Tensor) or t.device != device or t.dtype != torch.float32
            or t.dim() != 2 or t.shape[0] != rows or not t.is_contiguous()):
        raise ValueError(f"{who}: {name} must be a contiguous ({rows}, ·) float32 tensor on "
                         f"{device}")


def _page_args(who, cs, device, whole: bool):
    """The page walk's records ``(tree, tc, slot16, sc16, lo, hi, n_pages)``
    and its variant (``page_plan`` of their BVH4 depth): the pages of
    ``cs.bvh.paged``, or the one-level tree as one page.  Node and padded slot records are read as 16-byte
    loads, so each page's must start 16-byte aligned."""
    bvh = cs.bvh
    if whole:
        if bvh is None:
            raise ValueError(f"{who}: the scene has no BVH")
        if bvh.depth4 > MAX_DEPTH4:
            raise ValueError(f"{who}: the BVH4 is {bvh.depth4} deep; the kernel's stack takes "
                             f"at most {MAX_DEPTH4}")
        _check("nodes4", bvh.nodes4, torch.float32, bvh.nodes4.shape[0], device, who)
        slot16 = slot16_arg(who, cs, device)
        lo, hi = bvh.lo[:1], bvh.hi[:1]  # the root box
        args = (bvh.nodes4.data_ptr(), bvh.nodes4.shape[0], slot16, bvh.slot16.shape[0])
        n_pages, depth = 1, bvh.depth4
    else:
        pg = _paged(who, cs)
        n_pages, depth = pg.n_pages, pg.page_depth
        if pg.page_slot16 is None:
            raise ValueError(f"{who}: the paged BVH has no padded slot records "
                             f"(ops/bvh.pack_page_slot16)")
        _check_2d(who, "page_tree", pg.page_tree, n_pages, device)
        _check_2d(who, "page_slot16", pg.page_slot16, n_pages, device)
        if pg.page_slot16.shape[1] != pg.page_slot.shape[1] // 13 * 16:
            raise ValueError(f"{who}: page_slot16 must hold page_slot's records padded to 16 "
                             f"floats")
        for name, t in (("page_tree", pg.page_tree), ("page_slot16", pg.page_slot16)):
            if t.data_ptr() % 16 or t.shape[1] % 4:
                raise ValueError(f"{who}: {name}'s pages do not start 16-byte aligned")
        args = (pg.page_tree.data_ptr(), pg.page_tree.shape[1], pg.page_slot16.data_ptr(),
                pg.page_slot16.shape[1])
        lo, hi = pg.page_lo, pg.page_hi
    for name, t in (("page_lo", lo), ("page_hi", hi)):
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (n_pages, 3) \
                or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous ({n_pages}, 3) float32 tensor "
                             f"on {device}")
    return (*args, lo.data_ptr(), hi.data_ptr(), n_pages), page_plan(depth)


def _masks(who, plo, phi, n, device):
    if plo is None and phi is None:
        return None, None
    _check("plo", plo, torch.int32, n, device, who)
    _check("phi", phi, torch.int32, n, device, who)
    return plo.data_ptr(), phi.data_ptr()


def _offset(cs) -> int:
    return cs.n_planes + cs.n_spheres + cs.n_quads


# ---- plain versions -------------------------------------------------------------
def paged_top_closest_plain(cs, ro: V3, rd: V3, t_min: float, t_max, counts=None):
    """K6a's plain version: the plane/sphere/quad broadcast seeds the plain
    top walk (``ops/bvh.paged_top``)."""
    ps_idx, ps_t, _ = _closest_broadcast(cs, ro, rd, t_min, t_max, include_tris=False)
    t, prim, plo, phi = paged_top(cs.bvh, cs.triangles, ro, rd, t_min, ps_t, best_i=ps_idx,
                                  tri_offset=_offset(cs), counts=counts)
    return closest_record(cs, ro, rd, prim, t), plo, phi


def paged_top_any_plain(cs, ro: V3, rd: V3, t_min: float, limit, counts=None):
    """K6b's plain version (lanes with ``limit <= 0`` are not found)."""
    found = _ps_any(cs, ro, rd, t_min, limit, _CANDIDATES[:3])
    return paged_top(cs.bvh, cs.triangles, ro, rd, t_min, limit, any_hit=True, found=found,
                     counts=counts)


def pages_closest_plain(cs, ro: V3, rd: V3, t_min: float, best: ClosestRecord, plo=None,
                        phi=None, counts=None, mxu: bool = False) -> ClosestRecord:
    """K6c's plain version (``ops/bvh.pages``); without ``plo``/``phi``,
    K4c's: the skip-link walk of the whole tree from ``best``, and with
    ``mxu`` K10c's: the leaves tested by the leaf coefficient table, whose
    forms give a triangle winner's barycentrics and normal."""
    attrs = None
    if plo is None:
        t, prim = traverse_closest(cs.bvh, cs.triangles, ro, rd, t_min, best.t,
                                   tri_offset=_offset(cs), counts=counts, best_i=best.prim,
                                   leaf_mat=cs.bvh.leaf_mat if mxu else None)
        if mxu:
            attrs = leaf_attrs(cs.bvh, ro, rd, prim - _offset(cs))
    else:
        t, prim = pages(cs.bvh, cs.triangles, ro, rd, t_min, best.t, plo, phi, best_i=best.prim,
                        tri_offset=_offset(cs), counts=counts)
    return closest_record(cs, ro, rd, prim, t, tri_attrs=attrs)


def pages_any_plain(cs, ro: V3, rd: V3, t_min: float, limit, found, plo=None, phi=None,
                    counts=None, mxu: bool = False) -> torch.Tensor:
    """K6d's plain version; without ``plo``/``phi``, K4d's (with ``mxu``,
    K10d's: the leaves tested by the leaf coefficient table)."""
    if plo is None:
        return found | traverse_any(cs.bvh, cs.triangles, ro, rd, t_min,
                                    torch.where(found, -1.0, limit), counts=counts,
                                    leaf_mat=cs.bvh.leaf_mat if mxu else None)
    return pages(cs.bvh, cs.triangles, ro, rd, t_min, limit, plo, phi, any_hit=True, found=found,
                 counts=counts)


# ---- K6a / K6b: the top walk ----------------------------------------------------
def paged_top_closest(cs, ro: V3, rd: V3, t_min: float, t_max: float):
    """``(ClosestRecord, plo, phi)``: the plane/sphere/quad winner below the
    scalar ``t_max`` seeds the top tree's walk; the words hold each lane's
    pending pages (K6a, in the variant :func:`top_walk_plan` picks)."""
    who = "paged_top_closest"
    dev = ro.x.device
    if not _on(who, dev):
        return paged_top_closest_plain(cs, ro, rd, t_min, t_max)
    if isinstance(t_max, torch.Tensor):
        raise TypeError(f"{who}: the kernel takes a scalar t_max")
    top, plan = _top_args(who, cs, dev)
    n, rays = _rays(who, ro, rd)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    ints = torch.empty((3, n), dtype=torch.int32, device=dev)
    t, u, v, nx, ny, nz = out
    prim, plo, phi = ints
    if n > 0:
        lib = build().lib
        err = lib.ptrt_paged_top_closest(
            *top, *(r.data_ptr() for r in rays), n, gid_mask(cs), float(t_min), float(t_max),
            t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), nx.data_ptr(),
            ny.data_ptr(), nz.data_ptr(), plo.data_ptr(), phi.data_ptr(),
            *_top_launch(who, lib.ptrt_paged_top_closest_occupancy, plan, n, dev))
        _raise_on(who, err)
        paged_top_closest.launches += 1
    return ClosestRecord(t, prim, u, v, V3(nx, ny, nz)), plo, phi


def paged_top_any(cs, ro: V3, rd: V3, t_min: float, limit: torch.Tensor):
    """``(found, plo, phi)``: occlusion in ``(t_min, limit)`` (per ray) by
    the planes/spheres/quads and the top tree, and the pending pages of the
    lanes still unoccluded (K6b).  The kernel reports lanes with
    ``limit <= 0`` as found; the plain version as not found."""
    who = "paged_top_any"
    dev = ro.x.device
    if not _on(who, dev):
        return paged_top_any_plain(cs, ro, rd, t_min, limit)
    top, plan = _top_args(who, cs, dev)
    n, rays = _rays(who, ro, rd)
    _check("limit", limit, torch.float32, n, dev, who)
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    words = torch.empty((2, n), dtype=torch.int32, device=dev)
    plo, phi = words
    if n > 0:
        lib = build().lib
        err = lib.ptrt_paged_top_any(
            *top, *(r.data_ptr() for r in rays), limit.data_ptr(), n, float(t_min),
            found.data_ptr(), plo.data_ptr(), phi.data_ptr(),
            *_top_launch(who, lib.ptrt_paged_top_any_occupancy, plan, n, dev))
        _raise_on(who, err)
        paged_top_any.launches += 1
    return found, plo, phi


# ---- K6c / K6d (K4c / K4d): the page walks --------------------------------------
def pages_closest(cs, ro: V3, rd: V3, t_min: float, best: ClosestRecord, plo=None,
                  phi=None) -> ClosestRecord:
    """The record ``best`` carried through each lane's pending pages, in
    increasing index, each culled first by its root box at the carried
    ``t`` (K6c).  Without ``plo``/``phi``: through the whole one-level tree
    (K4c), ``best.t`` the per-ray bound."""
    who = "pages_closest"
    dev = ro.x.device
    if not _on(who, dev):
        return pages_closest_plain(cs, ro, rd, t_min, best, plo, phi)
    tree, plan = _page_args(who, cs, dev, plo is None)
    n, rays = _rays(who, ro, rd)
    masks = _masks(who, plo, phi, n, dev)
    carried = (best.t, best.prim, best.u, best.v, *best.normal)
    for name, x in zip(("t", "prim", "u", "v", "nx", "ny", "nz"), carried):
        _check(name, x, torch.int32 if name == "prim" else torch.float32, n, dev, who)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    t, u, v, nx, ny, nz = out
    if n > 0:
        lib = build().lib
        grid = launch_grid(who, lib.ptrt_pages_closest_occupancy, plan, n, dev)
        err = lib.ptrt_pages_closest(
            *tree, _offset(cs), gid_mask(cs), *(r.data_ptr() for r in rays), *masks,
            *(x.data_ptr() for x in carried), n, float(t_min), t.data_ptr(), prim.data_ptr(),
            u.data_ptr(), v.data_ptr(), nx.data_ptr(), ny.data_ptr(), nz.data_ptr(),
            lane_counter(dev).data_ptr(), plan.depth_class, grid, _stream(dev))
        _raise_on(who, err)
        pages_closest.launches += 1
    return ClosestRecord(t, prim, u, v, V3(nx, ny, nz))


def pages_any(cs, ro: V3, rd: V3, t_min: float, limit: torch.Tensor, found: torch.Tensor,
              plo=None, phi=None) -> torch.Tensor:
    """The found mask carried through each unoccluded lane's pending pages,
    up to the first hit in ``(t_min, limit)`` (K6d).  Without
    ``plo``/``phi``: through the whole one-level tree (K4d)."""
    who = "pages_any"
    dev = ro.x.device
    if not _on(who, dev):
        return pages_any_plain(cs, ro, rd, t_min, limit, found, plo, phi)
    tree, plan = _page_args(who, cs, dev, plo is None)
    tree = tree[:4] + tree[6:]  # the occlusion walk takes no root boxes
    n, rays = _rays(who, ro, rd)
    masks = _masks(who, plo, phi, n, dev)
    _check("limit", limit, torch.float32, n, dev, who)
    _check("found", found, torch.bool, n, dev, who)
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n > 0:
        lib = build().lib
        grid = launch_grid(who, lib.ptrt_pages_any_occupancy, plan, n, dev)
        err = lib.ptrt_pages_any(*tree, *(r.data_ptr() for r in rays), *masks, limit.data_ptr(),
                                 found.data_ptr(), n, float(t_min), out.data_ptr(),
                                 lane_counter(dev).data_ptr(), plan.depth_class, grid,
                                 _stream(dev))
        _raise_on(who, err)
        pages_any.launches += 1
    return out


# ---- the paged route of scene_hit / scene_hit_any -------------------------------
def scene_closest_paged(cs, ro: V3, rd: V3, t_min: float, t_max: float) -> SceneHit:
    """The closest hit on a paged scene: K6a, then K6c, as the ``SceneHit``
    of the JAX package's ``_fused_scene_hit``."""
    best, plo, phi = paged_top_closest(cs, ro, rd, t_min, t_max)
    rec = pages_closest(cs, ro, rd, t_min, best, plo, phi)
    return _fused_hit(cs, ro, rd, rec.t, rec.prim, rec.u, rec.v, rec.normal)


def scene_any_paged(cs, ro: V3, rd: V3, t_min: float, limit: torch.Tensor) -> torch.Tensor:
    """Occlusion on a paged scene: K6b, then K6d."""
    found, plo, phi = paged_top_any(cs, ro, rd, t_min, limit)
    return pages_any(cs, ro, rd, t_min, limit, found, plo, phi)


paged_top_closest.launches = 0  # kernel launches; the plain versions do not count
paged_top_any.launches = 0
pages_closest.launches = 0
pages_any.launches = 0
