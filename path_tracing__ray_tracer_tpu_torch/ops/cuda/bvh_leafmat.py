"""The BVH4 walks whose leaves are tested by the leaf coefficient table
(K10): the CUDA kernels ``csrc/bvh_leafmat.cu`` and their plain versions.

The kernels replace the JAX package's ``ops/pallas/bvh_pallas.py``
MXU-leaf walks, ``_bvh4_scene_closest_mxu_kernel`` (K10a),
``_bvh4_scene_any_mxu_kernel`` (K10b), ``_bvh4_closest_attrs_mxu_kernel``
(K10c) and ``_bvh4_any_mxu_kernel`` (K10d): K4a-K4d with each leaf's 16
Möller–Trumbore tests evaluated as linear forms of the ray features against
``FlatBVH.leaf_mat`` (``ops/bvh.pack_leaf_mat``).  ``ops/cuda/bvh.py``
sends a query here when :func:`~.bvh.mxu_leaf_ok` (the flag
``BVH_MXU_LEAF``, off by default, and a tree that carries a table).

* :func:`scene_closest` (K10a): the plane/sphere/quad sweep seeds the walk;
  the ``SceneHit`` as ``bvh.scene_closest`` returns it.
* :func:`scene_any` (K10b): occlusion in ``(t_min, limit)``; lanes with
  ``limit <= 0`` report occluded (the plain version: not occluded).
* :func:`tri_closest` (K10c): a carried :class:`~..intersect.ClosestRecord`
  through the whole tree, as ``bvh_paged.pages_closest`` without pages.
* :func:`tri_any` (K10d): a carried found mask through the whole tree, as
  ``bvh_paged.pages_any`` without pages.

Each launches its kernel on a CUDA tensor (or raises) and counts its
launches; on a CPU tensor it takes its plain version, the plain walks of
``ops/bvh.py`` with the table (``mxu=True``): ``scene_hit_bvh_plain``,
``scene_hit_any_bvh_plain``, ``pages_closest_plain``, ``pages_any_plain``.

All four are persistent walks, as the page walks are: :func:`scene_any_plan`
(K10a and K10b) and :func:`tri_plan` (K10c and K10d) give their variants (the
depth class of the BVH4, no tree staged; K10a's and K10b's shared memory is
the plane/sphere/quad blob, copied once per resident block),
``bvh.launch_grid`` the resident blocks, whose warps take their lanes from
``bvh.lane_counter``.  They read the node records and the table as 16-byte
loads, the table's over four slots of one feature row and quantity (the
table's columns and row stride are multiples of 4 floats; the wrappers check
the 16-byte alignment of the table and the node records).
"""
from __future__ import annotations

import ctypes

import torch

from ..bvh import _SLOT_F, LEAF_SIZE
from ..intersect import ClosestRecord, SceneHit, scene_hit_any_bvh_plain, scene_hit_bvh_plain
from ..v3 import V3
from .bounce import _check
from .bvh import (WalkPlan, _fused_hit, _on, _raise_on, _rays, closest_plan, gid_mask,
                  lane_counter, launch_grid, page_plan, tree_args)
from .bvh_paged import pages_any_plain, pages_closest_plain

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def build():
    """Compile (once per source hash) and load ``csrc/bvh_leafmat.cu``."""
    from . import build as _build

    built = _build.load("bvh_leafmat")
    lib = built.lib
    head = [_P, _I, _P, _L]
    rays = [_P] * 6
    lib.ptrt_mat_scene_closest.argtypes = (head + [_P, _I, _I, _I] + rays + [_I, _I, _F, _F]
                                           + [_P] * 7 + [_P, _I, _I, _I, _P])
    lib.ptrt_mat_scene_any.argtypes = (head + [_P, _I, _I, _I] + rays + [_P, _I, _F, _P]
                                       + [_P, _I, _I, _I, _P])
    lib.ptrt_mat_tri_closest.argtypes = (head + [_I, _I] + rays + [_P] * 7 + [_I, _F]
                                         + [_P] * 7 + [_P, _I, _I, _P])
    lib.ptrt_mat_tri_any.argtypes = head + rays + [_P, _P, _I, _F, _P] + [_P, _I, _I, _P]
    occupancy = (lib.ptrt_mat_scene_closest_occupancy, lib.ptrt_mat_scene_any_occupancy,
                 lib.ptrt_mat_tri_closest_occupancy, lib.ptrt_mat_tri_any_occupancy)
    for fn in occupancy:
        fn.argtypes = [_I] * 3 + [ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.ptrt_mat_scene_closest, lib.ptrt_mat_scene_any, lib.ptrt_mat_tri_closest,
               lib.ptrt_mat_tri_any, *occupancy):
        fn.restype = ctypes.c_int
    return built


def scene_any_plan(cs) -> WalkPlan:
    """The variant of K10a and K10b on ``cs``: their twin K4a's
    (``bvh.closest_plan``), the depth class of its BVH4, no tree staged,
    and the plane/sphere/quad blob as its shared memory."""
    return closest_plan(cs)


def tri_plan(cs) -> WalkPlan:
    """The variant of K10c and K10d on ``cs``: the depth class of its BVH4,
    nothing staged (as the whole-tree page walks K4c and K4d,
    ``bvh.page_plan``)."""
    return page_plan(cs.bvh.depth4)


def aligned_table_args(who, cs, device):
    """``(nodes, n_nodes, leaf_mat, stride, ps, P, S, Q)`` after checking the
    records (``bvh.tree_args``) and the table: a contiguous ``(16, 128·G)``
    float32 tensor on ``device`` with one group per leaf of the tree (``G``
    from its slot records); the table and the node records 16-byte aligned,
    as the walks' 16-byte loads need."""
    nodes, n_nodes, _slots, *ps = tree_args(who, cs, device)
    mat = cs.bvh.leaf_mat
    n_leaves = cs.bvh.slot_rec.shape[0] // (_SLOT_F * LEAF_SIZE)
    if mat is None:
        raise ValueError(f"{who}: the BVH carries no leaf coefficient table")
    if (mat.device != device or mat.dtype != torch.float32 or mat.dim() != 2
            or tuple(mat.shape) != (16, 128 * n_leaves) or not mat.is_contiguous()):
        raise ValueError(f"{who}: leaf_mat must be a contiguous (16, {128 * n_leaves}) float32 "
                         f"tensor on {device} (one 128-column group per leaf); got "
                         f"{tuple(mat.shape)} {mat.dtype} on {mat.device}")
    for name, t in (("leaf_mat", mat), ("nodes4", cs.bvh.nodes4)):
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")
    return (nodes, n_nodes, mat.data_ptr(), 128 * n_leaves, *ps)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def scene_closest(cs, ro: V3, rd: V3, t_min: float, t_max: float) -> SceneHit:
    """K10a: the closest hit on the whole scene below the scalar ``t_max``,
    in the persistent variant :func:`scene_any_plan` picks."""
    who = "leafmat.scene_closest"
    dev = ro.x.device
    if not _on(who, dev):
        return scene_hit_bvh_plain(cs, ro, rd, t_min, t_max, mxu=True)
    table = aligned_table_args(who, cs, dev)
    n, rays = _rays(who, ro, rd)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    t, u, v, nx, ny, nz = out
    if n:
        lib = build().lib
        plan = scene_any_plan(cs)
        grid = launch_grid(who, lib.ptrt_mat_scene_closest_occupancy, plan, n, dev)
        err = lib.ptrt_mat_scene_closest(
            *table, *(r.data_ptr() for r in rays), n, gid_mask(cs), float(t_min), float(t_max),
            t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), nx.data_ptr(),
            ny.data_ptr(), nz.data_ptr(), lane_counter(dev).data_ptr(), plan.depth_class,
            plan.smem_bytes, grid, _stream(dev))
        _raise_on(who, err)
        scene_closest.launches += 1
    return _fused_hit(cs, ro, rd, t, prim, u, v, V3(nx, ny, nz))


def scene_any(cs, ro: V3, rd: V3, t_min: float, limit: torch.Tensor) -> torch.Tensor:
    """K10b: is anything hit in ``(t_min, limit)`` (per ray)?  In the
    persistent variant :func:`scene_any_plan` picks."""
    who = "leafmat.scene_any"
    dev = ro.x.device
    if not _on(who, dev):
        return scene_hit_any_bvh_plain(cs, ro, rd, t_min, limit, mxu=True)
    table = aligned_table_args(who, cs, dev)
    n, rays = _rays(who, ro, rd)
    _check("limit", limit, torch.float32, n, dev, who)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    lib = build().lib
    plan = scene_any_plan(cs)
    grid = launch_grid(who, lib.ptrt_mat_scene_any_occupancy, plan, n, dev)
    err = lib.ptrt_mat_scene_any(*table, *(r.data_ptr() for r in rays), limit.data_ptr(), n,
                                 float(t_min), occ.data_ptr(), lane_counter(dev).data_ptr(),
                                 plan.depth_class, plan.smem_bytes, grid, _stream(dev))
    _raise_on(who, err)
    scene_any.launches += 1
    return occ


def tri_closest(cs, ro: V3, rd: V3, t_min: float, best: ClosestRecord) -> ClosestRecord:
    """K10c: the record ``best`` (``best.t`` the per-ray bound) carried
    through the whole tree's triangles, in the persistent variant
    :func:`tri_plan` picks."""
    who = "leafmat.tri_closest"
    dev = ro.x.device
    if not _on(who, dev):
        return pages_closest_plain(cs, ro, rd, t_min, best, mxu=True)
    table = aligned_table_args(who, cs, dev)[:4]
    n, rays = _rays(who, ro, rd)
    carried = (best.t, best.prim, best.u, best.v, *best.normal)
    for name, x in zip(("t", "prim", "u", "v", "nx", "ny", "nz"), carried):
        _check(name, x, torch.int32 if name == "prim" else torch.float32, n, dev, who)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    t, u, v, nx, ny, nz = out
    if n == 0:
        return ClosestRecord(t, prim, u, v, V3(nx, ny, nz))
    lib = build().lib
    plan = tri_plan(cs)
    grid = launch_grid(who, lib.ptrt_mat_tri_closest_occupancy, plan, n, dev)
    off = cs.n_planes + cs.n_spheres + cs.n_quads
    err = lib.ptrt_mat_tri_closest(
        *table, off, gid_mask(cs), *(r.data_ptr() for r in rays),
        *(x.data_ptr() for x in carried), n, float(t_min), t.data_ptr(), prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), nx.data_ptr(), ny.data_ptr(), nz.data_ptr(),
        lane_counter(dev).data_ptr(), plan.depth_class, grid, _stream(dev))
    _raise_on(who, err)
    tri_closest.launches += 1
    return ClosestRecord(t, prim, u, v, V3(nx, ny, nz))


def tri_any(cs, ro: V3, rd: V3, t_min: float, limit: torch.Tensor,
            found: torch.Tensor) -> torch.Tensor:
    """K10d: the found mask carried through the whole tree, up to the first
    triangle hit in ``(t_min, limit)``, in the persistent variant
    :func:`tri_plan` picks."""
    who = "leafmat.tri_any"
    dev = ro.x.device
    if not _on(who, dev):
        return pages_any_plain(cs, ro, rd, t_min, limit, found, mxu=True)
    table = aligned_table_args(who, cs, dev)[:4]
    n, rays = _rays(who, ro, rd)
    _check("limit", limit, torch.float32, n, dev, who)
    _check("found", found, torch.bool, n, dev, who)
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    lib = build().lib
    plan = tri_plan(cs)
    grid = launch_grid(who, lib.ptrt_mat_tri_any_occupancy, plan, n, dev)
    err = lib.ptrt_mat_tri_any(*table, *(r.data_ptr() for r in rays), limit.data_ptr(),
                               found.data_ptr(), n, float(t_min), out.data_ptr(),
                               lane_counter(dev).data_ptr(), plan.depth_class, grid, _stream(dev))
    _raise_on(who, err)
    tri_any.launches += 1
    return out


scene_closest.launches = 0  # kernel launches; the plain versions do not count
scene_any.launches = 0
tri_closest.launches = 0
tri_any.launches = 0
