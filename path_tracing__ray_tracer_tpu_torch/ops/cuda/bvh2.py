"""The BVH2 walks over the triangles: the CUDA kernels ``csrc/bvh2_walk.cu``
(K4e) and their plain torch versions.

The kernels replace the JAX package's ``ops/pallas/bvh_pallas.py``
``_bvh_closest_kernel`` and ``_bvh_closest_ordered_kernel`` (entered there
through ``_bvh_closest_unsorted``) and ``_bvh_any_kernel`` and
``_bvh_any_ordered_kernel`` (``_bvh_any_unsorted``).  They walk the BVH2
node records ``FlatBVH.tree2`` and the slot records, one ray per thread:
the skip-link walk in preorder with no stack, or the ordered walk, near
child first, with a stack of at most ``STACK_CAP`` nodes.  The split route
of ``ops/cuda/bvh.py`` takes them for a tree that the BVH4 walks do not
(``tri_route``: ``ordered`` or ``skiplink``).  All four are persistent
walks, as K4b is: the ordered walks' stack class ``bvh.depth2_class`` of
the tree's BVH2 depth (:func:`ordered_plan`; the skip-link walks have no
stack, :data:`SKIPLINK_PLAN`), ``bvh.launch_grid`` the resident blocks,
whose warps take their lanes from ``bvh.lane_counter``; they read the
padded slot records ``FlatBVH.slot16``.

* :func:`closest_skiplink` / :func:`closest_ordered`: ``(t, tri)``, the
  closest triangle below a scalar ``t_max`` or a per-ray seed bound, as a
  local triangle id (the packed uid stripped), −1 and the bound on a miss.
* :func:`any_skiplink` / :func:`any_ordered`: the bool occlusion mask for a
  per-ray limit; the kernels report lanes whose limit is ≤ 0 as occluded
  (their answer is not needed), the plain versions as not.

Each wrapper launches its kernel on a CUDA tensor (or raises) and takes its
plain version on a CPU tensor: the skip-link walks of ``ops/bvh.py``
(``traverse_closest``, ``traverse_any``) for both variants, whose winners
may differ only between triangles at exactly equal ``t``.  Each counts its
launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..bvh import traverse_any, traverse_closest
from ..v3 import V3
from .bounce import _check
from .bvh import (STACK_CAP, WalkPlan, _on, _raise_on, _rays, depth2_class, gid_mask,
                  lane_counter, launch_grid, slot16_arg)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build():
    """Compile (once per source hash) and load ``csrc/bvh2_walk.cu``."""
    from . import build as _build

    built = _build.load("bvh2")
    lib = built.lib
    lib.ptrt_bvh2_closest.argtypes = ([_P, _I, _P] + [_P] * 6 + [_I, _I, _I, _F, _F, _P, _P, _P]
                                      + [_P, _I, _I, _P])
    occupancy = [_I] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.ptrt_bvh2_closest_occupancy.argtypes = occupancy
    lib.ptrt_bvh2_skiplink_occupancy.argtypes = occupancy
    lib.ptrt_bvh2_any.argtypes = ([_P, _I, _P] + [_P] * 6 + [_P, _I, _I, _F, _P]
                                  + [_P, _I, _I, _P])
    lib.ptrt_bvh2_any_occupancy.argtypes = occupancy
    lib.ptrt_bvh2_skiplink_any_occupancy.argtypes = occupancy
    for fn in (lib.ptrt_bvh2_closest, lib.ptrt_bvh2_closest_occupancy,
               lib.ptrt_bvh2_skiplink_occupancy, lib.ptrt_bvh2_any, lib.ptrt_bvh2_any_occupancy,
               lib.ptrt_bvh2_skiplink_any_occupancy):
        fn.restype = ctypes.c_int
    lib.ptrt_bvh2_stack_cap.argtypes = []
    lib.ptrt_bvh2_stack_cap.restype = ctypes.c_int
    if lib.ptrt_bvh2_stack_cap() != STACK_CAP:
        raise RuntimeError(f"bvh2: the kernels' stack holds {lib.ptrt_bvh2_stack_cap()} nodes, "
                           f"ops/cuda/bvh.STACK_CAP says {STACK_CAP}")
    return built


def _tree_args(who, cs, device, ordered: bool):
    bvh = cs.bvh
    if bvh is None:
        raise ValueError(f"{who}: the scene has no BVH")
    cap = build().lib.ptrt_bvh2_stack_cap()
    if ordered and bvh.depth2 + 2 > cap:
        raise ValueError(f"{who}: the BVH2 is {bvh.depth2} deep; the ordered walk's stack "
                         f"takes at most {cap - 2}")
    m = bvh.tree2.shape[0] // 8
    _check("tree2", bvh.tree2, torch.float32, 8 * m, device, who)
    return bvh.tree2.data_ptr(), m


def ordered_plan(cs) -> WalkPlan:
    """The variant of the persistent ordered walks, closest and occlusion,
    on ``cs``: the stack class of its BVH2 depth, nothing staged."""
    return WalkPlan(False, depth2_class(cs.bvh.depth2), 0)


# The persistent skip-link walks' launch, whatever the tree: no stack
# (depth class 0), nothing staged.
SKIPLINK_PLAN = WalkPlan(False, 0, 0)


def _persistent(who, cs, dev, ordered: bool, occlusion: bool, n: int):
    """The launch arguments after ``tree2`` of the walk (ordered or skip-link,
    closest or occlusion): ``(slot16, lane counter, depth class, grid)``,
    after checking the 16-byte loads' alignment."""
    if cs.bvh.tree2.data_ptr() % 16:
        raise ValueError(f"{who}: tree2 is not 16-byte aligned")
    lib = build().lib
    plan = ordered_plan(cs) if ordered else SKIPLINK_PLAN
    occupancy = {(True, False): lib.ptrt_bvh2_closest_occupancy,
                 (True, True): lib.ptrt_bvh2_any_occupancy,
                 (False, False): lib.ptrt_bvh2_skiplink_occupancy,
                 (False, True): lib.ptrt_bvh2_skiplink_any_occupancy}[ordered, occlusion]
    return (slot16_arg(who, cs, dev), lane_counter(dev).data_ptr(), plan.depth_class,
            launch_grid(who, occupancy, plan, n, dev))


def _closest(wrapper, ordered: bool, cs, ro: V3, rd: V3, t_min: float, bound):
    who = wrapper.__name__
    dev = ro.x.device
    if not _on(who, dev):
        return traverse_closest(cs.bvh, cs.triangles, ro, rd, t_min, bound)
    tree = _tree_args(who, cs, dev, ordered)
    n, rays = _rays(who, ro, rd)
    per_ray = isinstance(bound, torch.Tensor)
    if per_ray:
        _check("bound", bound, torch.float32, n, dev, who)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    tri = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, tri
    slot16, *walk = _persistent(who, cs, dev, ordered, False, n)
    err = build().lib.ptrt_bvh2_closest(
        *tree, slot16, *(r.data_ptr() for r in rays), n, int(ordered), gid_mask(cs),
        float(t_min), 0.0 if per_ray else float(bound), bound.data_ptr() if per_ray else None,
        t.data_ptr(), tri.data_ptr(), *walk, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(who, err)
    wrapper.launches += 1
    return t, tri


def _any(wrapper, ordered: bool, cs, ro: V3, rd: V3, t_min: float, limit: torch.Tensor):
    who = wrapper.__name__
    dev = ro.x.device
    if not _on(who, dev):
        return traverse_any(cs.bvh, cs.triangles, ro, rd, t_min, limit)
    tree = _tree_args(who, cs, dev, ordered)
    n, rays = _rays(who, ro, rd)
    _check("limit", limit, torch.float32, n, dev, who)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    slot16, *walk = _persistent(who, cs, dev, ordered, True, n)
    err = build().lib.ptrt_bvh2_any(
        *tree, slot16, *(r.data_ptr() for r in rays), limit.data_ptr(), n, int(ordered),
        float(t_min), occ.data_ptr(), *walk, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(who, err)
    wrapper.launches += 1
    return occ


def closest_skiplink(cs, ro: V3, rd: V3, t_min: float, bound):
    """Closest triangle by the stackless skip-link walk (K4e), persistent."""
    return _closest(closest_skiplink, False, cs, ro, rd, t_min, bound)


def closest_ordered(cs, ro: V3, rd: V3, t_min: float, bound):
    """Closest triangle by the ordered stack walk, near child first (K4e)."""
    return _closest(closest_ordered, True, cs, ro, rd, t_min, bound)


def any_skiplink(cs, ro: V3, rd: V3, t_min: float, limit: torch.Tensor) -> torch.Tensor:
    """Occlusion by the stackless skip-link walk, a lane stopping at its
    first hit (K4e), persistent."""
    return _any(any_skiplink, False, cs, ro, rd, t_min, limit)


def any_ordered(cs, ro: V3, rd: V3, t_min: float, limit: torch.Tensor) -> torch.Tensor:
    """Occlusion by the ordered stack walk (K4e)."""
    return _any(any_ordered, True, cs, ro, rd, t_min, limit)


for _w in (closest_skiplink, closest_ordered, any_skiplink, any_ordered):
    _w.launches = 0  # kernel launches; the plain versions do not count
