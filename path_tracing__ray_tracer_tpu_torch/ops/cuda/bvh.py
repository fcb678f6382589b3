"""Whole-scene intersection of a BVH scene: the route among the BVH walks,
the CUDA kernels ``csrc/bvh_scene.cu`` and their plain torch versions.

``ops/intersect.scene_hit`` and ``scene_hit_any`` call :func:`scene_closest`
and :func:`scene_any` for every scene with a BVH.  :func:`tri_route` picks
the triangle walk as the JAX package's ``scene_hit`` and
``bvh_pallas.bvh_closest_pallas`` do, reading this module's copies of its
route flags at each call:

* ``fused`` (K4a / K4b, and K5 for the path tracer's bounce): one launch
  sweeps the planes, spheres and quads and walks the BVH4 seeded with their
  winner.  ``bvh_scene.cu``'s kernels replace
  ``ops/pallas/bvh_pallas.py::_bvh4_scene_closest_kernel`` (K4a, entered
  there through ``bvh_scene_closest_pallas``) and ``::_bvh4_scene_any_kernel``
  (K4b, ``bvh_scene_any_pallas``); their plain versions are
  ``ops/intersect.scene_hit_bvh_plain`` and ``scene_hit_any_bvh_plain``.
  The closest kernel emits t, prim, the shading normal and, for a triangle
  winner, its raw barycentrics, from which the wrapper interpolates the
  triangle's UVs where a textured triangle reads them (else 0), as the JAX
  package's ``_fused_scene_hit`` does.
* ``paged`` (K6, ``ops/cuda/bvh_paged.py``): the two-level walk of a paged
  tree; plain versions ``scene_hit_paged_plain`` and
  ``scene_hit_any_paged_plain``.
* the *split* route, ``quad`` (K4c / K4d), ``multipass`` (K11, then K4d for
  occlusion), ``ordered`` or ``skiplink`` (K4e, ``ops/cuda/bvh2.py``): the
  plane/sphere/quad broadcast, the triangle walk, and the strict-``<``
  combine of the JAX ``scene_hit`` (occlusion: the broadcast's verdict or
  the walk's).  A per-ray closest-hit bound always takes it.

:func:`mxu_leaf_ok` (the JAX ``BVH_MXU_LEAF`` gate, off by default) swaps
the leaf visit of the BVH4 walks for the leaf coefficient table's linear
forms, not the walk: K10a / K10b on the ``fused`` route, K10c / K10d on
``quad``, K10d for ``multipass`` occlusion (``ops/cuda/bvh_leafmat.py``).
K5's closest hit and K11 have no such variant, as in the JAX package.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it takes its plain version, so the CPU runs the same route.  The
occlusion kernels report lanes whose bound is ≤ 0 as occluded (their answer
is not needed; the plain versions say not occluded).

K4a, K4b and K5 are persistent walks (``csrc/bvh_walk.cuh``): :func:`walk_plan`
picks K4b's and K5's variant from sizes alone, against the budget
``SMEM_TREE_BYTES`` (a node table at most this large is copied into each
block's shared memory), a module global read at each call that tests and
scripts may set; K4a's, :func:`closest_plan`, stages no tree whatever the
budget; :func:`persistent_grid` launches only the resident blocks, which
take their lanes from :func:`lane_counter`.
They read the padded slot records ``FlatBVH.slot16``.  So do K11
(:func:`closest_rooted`, its variant :func:`rooted_plan`) and the ordered
BVH2 walks (``bvh2.closest_ordered`` and ``bvh2.any_ordered``, their stack
class :func:`depth2_class`), which stage nothing.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..bvh import GID_TRI_MASK, rooted, subtree_keys2, subtree_nodes
from ..intersect import (
    _CANDIDATES,
    _bound,
    ClosestRecord,
    SceneHit,
    _closest_broadcast,
    _hit_record,
    _ps_any,
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

# The JAX package's route flags (ops/pallas/bvh_pallas.py), with its
# defaults; read at each call, so tests and scripts may set them.
BVH_QUAD = True  # the BVH4 walks (else the BVH2 walks K4e)
BVH_ORDERED = True  # the ordered BVH2 walk (else the skip-link walk)
BVH_ATTRS = True  # the fused scene walks K4a/K4b (else the split route)
BVH_MULTIPASS = False  # the multipass closest hit, K11
_MP_MIN_DEPTH4 = 4  # shallower BVH4s take no multipass
BVH_MXU_LEAF = False  # leaves tested by the leaf coefficient table (K10)
# Not a flag: the ordered BVH2 walk's stack, fixed in csrc/bvh2_walk.cu
# (kStack2Cap); ops/cuda/bvh2.build checks that the two agree.
STACK_CAP = 192
# The persistent ordered BVH2 walks' smaller stack class (csrc/bvh2_walk.cu
# kShallow2); a deeper tree's stack holds STACK_CAP.
SHALLOW2 = 32

# The persistent K4b and K5 (csrc/bvh_walk.cuh kWalkThreads, kShallow4): the
# block, and the depth class whose stack holds 3·8 − 2 = 22 entries (a deeper
# tree's holds 3·32 − 2).
WALK_THREADS = 256
SHALLOW4 = 8
# A bound on the kernels' static shared memory (16 B in the staged variants:
# the copy's mbarrier), which the card's per-block limit also holds.
_STATIC_SMEM = 64
# The budget, read at each call: the node table is staged when it is at most
# SMEM_TREE_BYTES.  0: every tree is read from device memory, as 16-byte
# loads through the read-only cache.  Staging config 5's 66,688 B table was
# measured no faster on an H100 (within ±3% either way, K4b and K5; PERF.md),
# so no tree is staged unless a caller raises the budget.
SMEM_TREE_BYTES = 0


class WalkPlan(NamedTuple):
    stage: bool  # the node table is copied into each block's shared memory
    depth_class: int  # SHALLOW4 or MAX_DEPTH4: the stack holds 3·class − 2 entries
    smem_bytes: int  # dynamic shared memory of a block: the staged tree, the tables


def depth_class(depth4: int) -> int:
    """The persistent walks' stack class of a BVH4 of depth ``depth4``."""
    return SHALLOW4 if depth4 <= SHALLOW4 else MAX_DEPTH4


def depth2_class(depth2: int) -> int:
    """The persistent ordered BVH2 walks' stack class of a BVH2 of depth
    ``depth2``: the entries its stack holds, at least ``depth2 + 2``
    (the ordered walk holds at most ``depth2 + 1`` nodes) when the tree is
    at most ``STACK_CAP − 2`` deep, as ``tri_route`` sends it."""
    return SHALLOW2 if depth2 + 2 <= SHALLOW2 else STACK_CAP


def walk_plan(n_nodes: int, depth4: int, table_bytes: int, limit: int) -> WalkPlan:
    """The variant of a persistent walk over ``n_nodes`` BVH4 nodes of depth
    ``depth4``, whose kernel stages ``table_bytes`` of its own tables, on a
    card whose blocks may take ``limit`` bytes of dynamic shared memory
    (:func:`smem_limit`): a pure function of these sizes and the budget."""
    tree = 4 * 32 * n_nodes
    stage = tree <= SMEM_TREE_BYTES and tree + table_bytes <= limit
    return WalkPlan(stage, depth_class(depth4), table_bytes + (tree if stage else 0))


def page_plan(depth4: int) -> WalkPlan:
    """The variant of the page walks (K6c/K6d, and K4c/K4d over the whole
    tree as one page) over trees of depth ``depth4``: its depth class, and
    nothing in shared memory whatever the budget (a config-6 page of
    ~800 KB is far past a block's shared memory, and staging config 5's
    node table measured no faster)."""
    return WalkPlan(False, depth_class(depth4), 0)


def smem_limit(dev) -> int:
    """The dynamic shared memory a block of the persistent walks may take on
    ``dev``: the card's opt-in limit per block less their static share."""
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin - _STATIC_SMEM


def persistent_grid(n: int, n_sms: int, blocks_per_sm: int) -> int:
    """Blocks of a persistent launch over ``n`` lanes: the resident ones,
    or fewer when fewer cover the lanes once."""
    return max(1, min(-(-n // WALK_THREADS), n_sms * blocks_per_sm))


_RESIDENT = {}  # (kernel, device index, plan) -> resident blocks per SM


def launch_grid(who, occupancy, plan, n: int, dev) -> int:
    """``persistent_grid`` for ``plan`` (a ``WalkPlan``, or any tuple of
    ints whose last is the dynamic shared memory) on ``dev``, with the
    blocks per SM that the kernel's ``occupancy`` entry reports, called with
    the plan's fields and the out pointer (asked once per plan; it also
    allows the plan's shared memory, so a launch needs no attribute)."""
    key = (who, dev.index, plan)
    if key not in _RESIDENT:
        blocks = ctypes.c_int(0)
        _raise_on(who, occupancy(*(int(x) for x in plan), ctypes.byref(blocks)))
        if blocks.value < 1:
            raise RuntimeError(f"{who}: no block of {plan} fits an SM")
        _RESIDENT[key] = blocks.value
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return persistent_grid(n, n_sms, _RESIDENT[key])


_COUNTERS = {}  # (device index, stream) -> the persistent walks' lane counter


def lane_counter(dev) -> torch.Tensor:
    """The lane counter of the persistent walks on ``dev``'s current stream:
    two int32 (the next lane, the blocks done), zero between launches, since
    each launch's last block zeroes them (``bvh_walk.cuh`` finish_lanes).
    Launches on one stream share it; another stream has its own.  A CUDA
    graph holds the counter of the stream it was captured on (``ops/cuda.
    capture``'s side stream, whose counter is made before any capture) and
    replays on the caller's stream after the warm-up on the side stream, so
    its launches never overlap another user of that counter."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros((2,), dtype=torch.int32, device=dev)
    return _COUNTERS[key]


def slot16_arg(who, cs, device) -> int:
    """The padded slot records' pointer, after checking them (16-byte
    loads need 16-byte alignment; so do the node records)."""
    bvh = cs.bvh
    if bvh.slot16 is None:
        raise ValueError(f"{who}: the BVH has no padded slot records (ops/bvh.pack_slot16)")
    _check("slot16", bvh.slot16, torch.float32, bvh.slot_rec.shape[0] // 13 * 16, device, who)
    for name, t in (("slot16", bvh.slot16), ("nodes4", bvh.nodes4)):
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} is not 16-byte aligned")
    return bvh.slot16.data_ptr()


def tri_route(cs, per_ray: bool = False) -> str:
    """The triangle walk of ``cs``'s BVH: ``fused``, ``paged``, ``quad``,
    ``multipass``, ``ordered`` or ``skiplink`` (see the module's docstring).
    ``per_ray``: a closest-hit query with a per-ray bound, which neither the
    fused nor the paged kernels take.

    The JAX package's gates, with its TPU terms replaced:

    * the BVH4 walks need ``BVH_QUAD`` and ``depth4 ≤ MAX_DEPTH4``: the
      per-thread stack of ``csrc/bvh_walk.cuh`` in place of the JAX
      ``3·depth4 + 2 ≤ 192`` (``_quad_ok``);
    * ``fused`` also needs ``BVH_ATTRS`` (``_scene_fused_ok``; its SMEM
      budgets have no counterpart here);
    * ``multipass`` needs ``BVH_MULTIPASS`` and ``depth4 ≥ _MP_MIN_DEPTH4``
      (``_mp_ok``, less its ``BVH_SORT`` and ``n ≥ 16·128`` terms: each lane
      walks from its own root, so there is no coherence sort and no block
      of 1,024 lanes to fill);
    * ``ordered`` needs ``BVH_ORDERED`` and ``depth2 + 2 ≤ STACK_CAP``
      (``_ordered_ok``), else ``skiplink``;
    * a paged tree takes ``paged`` when its top and page depths both fit
      the BVH4 stack (the JAX ``paged_ok``), else the BVH2 walks over the
      whole tree, which the card holds whole."""
    bvh = cs.bvh
    if not per_ray and bvh.paged is not None:
        if max(bvh.paged.top_depth, bvh.paged.page_depth) <= MAX_DEPTH4:
            return "paged"
        return _bvh2_route(bvh)
    quad = BVH_QUAD and bvh.depth4 <= MAX_DEPTH4
    if quad and BVH_ATTRS and not per_ray:
        return "fused"
    if quad and BVH_MULTIPASS and bvh.depth4 >= _MP_MIN_DEPTH4:
        return "multipass"
    return "quad" if quad else _bvh2_route(bvh)


def mxu_leaf_ok(cs) -> bool:
    """Do the BVH4 walks of ``cs`` test leaves by the leaf coefficient table
    (K10)?  The JAX ``_mxu_leaf_ok`` less its ``LEAF_MAT_VMEM_BYTES`` term,
    a TPU VMEM budget: the table lives in device memory here.  Only a
    one-level tree carries a table (``ops/bvh.to_device``)."""
    return BVH_MXU_LEAF and cs.bvh.leaf_mat is not None


def _bvh2_route(bvh) -> str:
    return "ordered" if BVH_ORDERED and bvh.depth2 + 2 <= STACK_CAP else "skiplink"


def build():
    """Compile (once per source hash) and load ``csrc/bvh_scene.cu``."""
    from . import build as _build

    built = _build.load("bvh_scene")
    lib = built.lib
    head = [_P, _I, _P, _P, _I, _I, _I] + [_P] * 6
    lib.ptrt_bvh_closest.argtypes = head + [_I, _I, _F, _F] + [_P] * 7 + [_P, _I, _I, _I, _P]
    lib.ptrt_bvh_any.argtypes = head + [_P, _I, _F, _P, _P] + [_I] * 4 + [_P]
    occupancy = [_I] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.ptrt_bvh4_closest_rooted.argtypes = ([_P, _I, _P] + [_P] * 10 + [_I, _I, _F, _P, _P]
                                             + [_P, _I, _I, _P])
    entries = (lib.ptrt_bvh_closest, lib.ptrt_bvh_any, lib.ptrt_bvh4_closest_rooted)
    occupancies = (lib.ptrt_bvh_closest_occupancy, lib.ptrt_bvh_any_occupancy,
                   lib.ptrt_bvh4_rooted_occupancy)
    for fn in occupancies:
        fn.argtypes = occupancy
    for fn in entries + occupancies:
        fn.restype = ctypes.c_int
    return built


def tree_args(who, cs, device):
    """The walk's records as launch arguments ``(nodes, n_nodes, slots, ps,
    P, S, Q)``, after checking them against ``cs`` and the kernel's limits
    (``tri_route`` sends no deeper tree here)."""
    bvh = cs.bvh
    if bvh is None:
        raise ValueError(f"{who}: the scene has no BVH")
    if bvh.depth4 > MAX_DEPTH4:
        raise ValueError(f"{who}: the BVH4 is {bvh.depth4} deep; the kernel's stack takes "
                         f"at most {MAX_DEPTH4} (tri_route sends such a tree to K4e)")
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


def _on(who, dev) -> bool:
    """Is ``dev`` the card (else the CPU)?  Raises for any other device."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for device {dev}")
    return dev.type == "cuda"


def scene_closest(cs, ro: V3, rd: V3, t_min: float, t_max) -> SceneHit:
    """Closest hit of every ray in ``(t_min, t_max)`` on a BVH scene, by
    :func:`tri_route`: K4a (K10a by the leaf table, :func:`mxu_leaf_ok`), K6,
    or the split route (always for a tensor ``t_max``).  Rays on the CPU take
    the plain versions."""
    on_card = _on("scene_closest", ro.x.device)
    route = tri_route(cs, per_ray=isinstance(t_max, torch.Tensor))
    if route == "paged":
        if not on_card:
            return scene_hit_paged_plain(cs, ro, rd, t_min, t_max)
        from . import bvh_paged

        return bvh_paged.scene_closest_paged(cs, ro, rd, t_min, t_max)
    if route == "fused":
        if mxu_leaf_ok(cs):
            from . import bvh_leafmat

            return bvh_leafmat.scene_closest(cs, ro, rd, t_min, t_max)
        return _fused_closest(cs, ro, rd, t_min, t_max) if on_card else scene_hit_bvh_plain(
            cs, ro, rd, t_min, t_max)
    return split_closest(cs, ro, rd, t_min, t_max, route)


def _fused_closest(cs, ro: V3, rd: V3, t_min: float, t_max: float) -> SceneHit:
    """K4a: the plane/sphere/quad sweep seeds the BVH4 walk, one launch, in
    the persistent variant :func:`closest_plan` picks."""
    who = "scene_closest"
    dev = ro.x.device
    nodes, n_nodes, _slots, ps, P, S, Q = tree_args(who, cs, dev)
    slot16 = slot16_arg(who, cs, dev)
    n, rays = _rays(who, ro, rd)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    t, u, v, nx, ny, nz = out
    if n:
        lib = build().lib
        plan = closest_plan(cs)
        grid = launch_grid(who, lib.ptrt_bvh_closest_occupancy, plan, n, dev)
        err = lib.ptrt_bvh_closest(
            nodes, n_nodes, slot16, ps, P, S, Q, *(r.data_ptr() for r in rays), n, gid_mask(cs),
            float(t_min), float(t_max), t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
            nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), lane_counter(dev).data_ptr(),
            plan.depth_class, plan.smem_bytes, grid, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(who, err)
        scene_closest.launches += 1
    return _fused_hit(cs, ro, rd, t, prim, u, v, V3(nx, ny, nz))


def closest_plan(cs) -> WalkPlan:
    """The persistent K4a's variant on ``cs`` (K10a's and K10b's too,
    ``bvh_leafmat.scene_any_plan``): the depth class of its BVH4, no tree
    staged whatever ``SMEM_TREE_BYTES`` is (staging measured ±3-4% on K4b
    and K5), and the plane/sphere/quad blob as its shared memory."""
    return WalkPlan(False, depth_class(cs.bvh.depth4), 4 * cs.bvh.ps_blob.numel())


def split_closest(cs, ro: V3, rd: V3, t_min: float, t_max, route: str) -> SceneHit:
    """The JAX ``scene_hit``'s split route: the plane/sphere/quad broadcast,
    the triangle walk ``route`` below the bound (K4c, or K10c by the leaf
    table, with the winner's raw barycentrics and stored normal; K11 or K4e
    with its local id, whose attributes ``_hit_record`` recomputes), the
    strict-``<`` combine."""
    from . import bvh2, bvh_leafmat, bvh_paged

    n = ro.x.shape[0]
    bound = _bound(t_max, n, ro.x).contiguous()
    ps_idx, ps_t, ps_hit = _closest_broadcast(cs, ro, rd, t_min, bound, include_tris=False)
    attrs = None
    if route == "quad":
        zero = torch.zeros_like(bound)
        seed = ClosestRecord(bound, torch.full((n,), -1, dtype=torch.int32, device=bound.device),
                             zero, zero, V3(zero, zero, zero))
        walk = bvh_leafmat.tri_closest if mxu_leaf_ok(cs) else bvh_paged.pages_closest
        tri = walk(cs, ro, rd, t_min, seed)
        tri_t, tri_idx, attrs = tri.t, tri.prim, (tri.u, tri.v, tri.normal)
    else:
        if route == "multipass":
            tri_t, local = multipass_closest(cs, ro, rd, t_min, bound)
        else:
            walk = bvh2.closest_ordered if route == "ordered" else bvh2.closest_skiplink
            tri_t, local = walk(cs, ro, rd, t_min, bound)
        tri_idx = torch.where(local >= 0, local + (cs.n_planes + cs.n_spheres + cs.n_quads), -1)
    tri_hit = tri_idx >= 0
    tri_wins = tri_hit & (~ps_hit | (tri_t < ps_t))
    return _hit_record(cs, ro, rd, torch.where(tri_wins, tri_idx, ps_idx),
                       torch.where(tri_wins, tri_t, ps_t), ps_hit | tri_hit,
                       tri_uv=tri_uv_read(cs), tri_attrs=attrs)


def scene_any(cs, ro: V3, rd: V3, t_min: float, limit) -> torch.Tensor:
    """Bool mask: is anything hit in ``(t_min, limit)`` on a BVH scene?
    ``limit`` is per ray, or a scalar that is broadcast.  By
    :func:`tri_route`: K4b (``fused``; K10b by the leaf table), K6
    (``paged``), or the plane/sphere/quad broadcast and the triangle walk K4d
    (``quad``, ``multipass``; K10d by the leaf table) or K4e.  Rays on the
    CPU take the plain versions."""
    on_card = _on("scene_any", ro.x.device)
    route = tri_route(cs)
    n = int(ro.x.shape[0])
    if not isinstance(limit, torch.Tensor):
        limit = torch.full((n,), float(limit), dtype=torch.float32, device=ro.x.device)
    if route == "paged":
        if not on_card:
            return scene_hit_any_paged_plain(cs, ro, rd, t_min, limit)
        from . import bvh_paged

        return bvh_paged.scene_any_paged(cs, ro, rd, t_min, limit)
    if route == "fused":
        if mxu_leaf_ok(cs):
            from . import bvh_leafmat

            return bvh_leafmat.scene_any(cs, ro, rd, t_min, limit)
        return _fused_any(cs, ro, rd, t_min, limit) if on_card else scene_hit_any_bvh_plain(
            cs, ro, rd, t_min, limit)
    return split_any(cs, ro, rd, t_min, limit, route)


def _fused_any(cs, ro: V3, rd: V3, t_min: float, limit: torch.Tensor) -> torch.Tensor:
    """K4b: the plane/sphere/quad sweep, then the BVH4 occlusion walk, in
    the persistent variant :func:`walk_plan` picks."""
    who = "scene_any"
    dev = ro.x.device
    nodes, n_nodes, _slots, ps, P, S, Q = tree_args(who, cs, dev)
    slot16 = slot16_arg(who, cs, dev)
    n, rays = _rays(who, ro, rd)
    _check("limit", limit, torch.float32, n, dev, who)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    lib = build().lib
    plan = any_plan(cs, smem_limit(dev))
    grid = launch_grid(who, lib.ptrt_bvh_any_occupancy, plan, n, dev)
    err = lib.ptrt_bvh_any(nodes, n_nodes, slot16, ps, P, S, Q, *(r.data_ptr() for r in rays),
                           limit.data_ptr(), n, float(t_min), occ.data_ptr(),
                           lane_counter(dev).data_ptr(), int(plan.stage), plan.depth_class,
                           plan.smem_bytes, grid, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(who, err)
    scene_any.launches += 1
    return occ


def any_plan(cs, limit: int) -> WalkPlan:
    """The persistent K4b's variant on ``cs`` under the shared memory
    ``limit``: its own table is the plane/sphere/quad blob."""
    return walk_plan(cs.bvh.nodes4.shape[0] // 32, cs.bvh.depth4, 4 * cs.bvh.ps_blob.numel(),
                     limit)


def split_any(cs, ro: V3, rd: V3, t_min: float, limit: torch.Tensor, route: str) -> torch.Tensor:
    """Occlusion on the split route: the plane/sphere/quad broadcast's
    verdict, or the triangle walk's for the lanes it leaves unoccluded (the
    JAX ``scene_hit_any``'s ``ps_any | walk``): K4d, or K10d by the leaf
    table, on the ``quad`` and ``multipass`` routes."""
    from . import bvh2, bvh_leafmat, bvh_paged

    found = _ps_any(cs, ro, rd, t_min, limit, _CANDIDATES[:3])
    if route in ("quad", "multipass"):
        walk = bvh_leafmat.tri_any if mxu_leaf_ok(cs) else bvh_paged.pages_any
        return walk(cs, ro, rd, t_min, limit, found)
    walk = bvh2.any_ordered if route == "ordered" else bvh2.any_skiplink
    return found | walk(cs, ro, rd, t_min, torch.where(found, -1.0, limit))


# ---- K11: the multipass closest hit ----------------------------------------------
def rooted_plan(cs) -> WalkPlan:
    """K11's variant on ``cs``: the depth class of its whole BVH4 (a walk
    from a subtree root is shallower, so its stack holds it too), nothing
    staged, as the page walks' :func:`page_plan`."""
    return page_plan(cs.bvh.depth4)


def closest_rooted(cs, ro: V3, rd: V3, t_min: float, roots, en, bt0, bi0):
    """One multipass pass (K11): each lane with ``en`` walks the BVH4
    subtree from its own root ``roots`` (int32 BVH4 node ids) with its
    carried ``(bt0, bi0)`` (local triangle ids); other lanes pass them
    through.  Returns ``(bt, bi)``.  The plain version walks each root's
    BVH2 range (``ops/bvh.rooted``).  The kernel is a persistent walk in the
    variant :func:`rooted_plan` picks, over ``FlatBVH.slot16``."""
    who = "closest_rooted"
    if not _on(who, ro.x.device):
        return rooted(cs.bvh, cs.triangles, ro, rd, t_min, roots, en, bt0, bi0)
    dev = ro.x.device
    nodes, n_nodes = tree_args(who, cs, dev)[:2]
    slot16 = slot16_arg(who, cs, dev)
    n, rays = _rays(who, ro, rd)
    for name, x, dtype in (("roots", roots, torch.int32), ("en", en, torch.bool),
                           ("bt0", bt0, torch.float32), ("bi0", bi0, torch.int32)):
        _check(name, x, dtype, n, dev, who)
    bt = torch.empty((n,), dtype=torch.float32, device=dev)
    bi = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return bt, bi
    lib = build().lib
    plan = rooted_plan(cs)
    grid = launch_grid(who, lib.ptrt_bvh4_rooted_occupancy, plan, n, dev)
    err = lib.ptrt_bvh4_closest_rooted(
        nodes, n_nodes, slot16, *(r.data_ptr() for r in rays), roots.data_ptr(), en.data_ptr(),
        bt0.data_ptr(), bi0.data_ptr(), n, gid_mask(cs), float(t_min), bt.data_ptr(),
        bi.data_ptr(), lane_counter(dev).data_ptr(), plan.depth_class, grid,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(who, err)
    closest_rooted.launches += 1
    return bt, bi


def multipass_closest(cs, ro: V3, rd: V3, t_min: float, bound: torch.Tensor):
    """``(t, local triangle id)``: the JAX package's ``_bvh_closest_multipass``
    with a root per lane.  Pass 1 walks the depth-2 subtree each ray enters
    first, pass 2 the one it enters second, each from the best so far; a
    cleanup pass from the root makes the result exact whatever the
    predictions (``ops/bvh.subtree_keys2``) chose.  The JAX package's
    coherence sort and its ``_base_key`` are left out: they group the lanes
    of a TPU block under one root, and here every lane has its own."""
    n = ro.x.shape[0]
    table, valid = subtree_nodes(cs.bvh.nodes4)
    bt = bound
    bi = torch.full((n,), -1, dtype=torch.int32, device=bound.device)
    for s in subtree_keys2(cs.bvh.nodes4, ro, rd):
        sc = torch.clamp(s, 0, 15).long()
        en = valid[sc] & (s < 16)
        roots = torch.where(en, table[sc], 0).to(torch.int32).contiguous()
        bt, bi = closest_rooted(cs, ro, rd, t_min, roots, en.contiguous(), bt, bi)
    zero = torch.zeros((n,), dtype=torch.int32, device=bound.device)
    return closest_rooted(cs, ro, rd, t_min, zero, torch.ones_like(zero, dtype=torch.bool), bt, bi)


scene_closest.launches = 0  # kernel launches; the plain versions do not count
scene_any.launches = 0
closest_rooted.launches = 0
