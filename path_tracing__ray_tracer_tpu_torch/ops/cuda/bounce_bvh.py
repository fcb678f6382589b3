"""One path-tracer bounce on a BVH scene: the CUDA kernel
``csrc/path_bounce_bvh.cu`` (K5) and the tables it reads.

The kernel replaces the JAX package's
``ops/pallas/bounce_bvh_pallas.py::_path_bounce_bvh_kernel`` (entered there
through ``path_bounce_bvh_pallas``) in its shipped split form: one launch
does the closest hit, the material, NEE preparation, Russian roulette and
the scatter, and emits each lane's shadow ray; a second launch, the K4b
occlusion walk (``ops/cuda/bvh.scene_any``), answers them, and this wrapper
zeroes ``w_nee`` where a shadow ray is occluded.

* :func:`bounce_bvh_ok` is the static gate (the JAX package's
  ``bounce_bvh_ok`` less its TPU select-chain limits): a BVH whose slot
  gids carry unique-material ids, a unique-material table, no textured
  triangle.  A BVH scene that fails it takes ``path_bounce_plain``, whose
  ``scene_hit`` and ``scene_hit_any`` launch K4a and K4b on the card.
* :func:`pack_bvh_tables` packs what the kernel stages beside the tree:
  the unique ids of the non-triangle primitives, the unique-material table
  and the light samples.
* :func:`path_bounce_bvh` is the wrapper.  Its plain version is
  ``ops/cuda/bounce.path_bounce_plain`` on the same scene: a CPU tensor
  takes it.  K5 is a persistent walk whose variant
  ``ops/cuda/bvh.walk_plan`` picks from sizes, as K4b's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..v3 import V3
from .bounce import (
    _MAT_FIELDS,
    _N_FIELDS,
    T_MAX,
    T_MIN,
    BounceOut,
    _check,
    pack_light_blob,
    path_bounce_plain,
)
from .bvh import (WalkPlan, lane_counter, launch_grid, scene_any, slot16_arg, smem_limit,
                  tree_args, walk_plan)

_N_SHADOW = 7  # rows of the shadow record: origin, direction, limit


class BvhTables(NamedTuple):
    psuid: torch.Tensor  # (P+S+Q,) f32 unique-material id of each non-triangle primitive
    umat: torch.Tensor  # (10·U,) f32 unique-material table, field-major
    light: torch.Tensor  # (3·L,) f32 light samples


def bounce_bvh_ok(cs) -> bool:
    """Can K5 take this scene's bounces?"""
    bvh = cs.bvh
    return (bvh is not None and bvh.uid_packed and cs.mat_table is not None
            and cs.tri_uv_used is not None and cs.tri_uv_used.shape[0] == 0)


def pack_bvh_tables(cs) -> BvhTables:
    """The tables K5 stages in shared memory (the JAX package's
    ``pack_psuid_blob``, ``pack_umat_blob`` and ``pack_light_blob``)."""
    mt = cs.mat_table
    psq = cs.n_planes + cs.n_spheres + cs.n_quads
    umat = torch.cat([*mt.color, mt.diffuse, mt.specular, mt.reflective, mt.refractive, mt.ior,
                      mt.has_tex, mt.tex_id.to(torch.float32)])
    return BvhTables(cs.mat_uid[:psq].to(torch.float32).contiguous(), umat.contiguous(),
                     pack_light_blob(cs))


def bounce_plan(cs, tables: BvhTables, limit: int) -> WalkPlan:
    """The persistent K5's variant on ``cs`` under the shared memory
    ``limit``: its own tables are the plane/sphere/quad blob and ``tables``."""
    floats = cs.bvh.ps_blob.numel() + sum(t.numel() for t in tables)
    return walk_plan(cs.bvh.nodes4.shape[0] // 32, cs.bvh.depth4, 4 * floats, limit)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build():
    """Compile (once per source hash) and load ``csrc/path_bounce_bvh.cu``."""
    from . import build as _build

    built = _build.load("path_bounce_bvh")
    lib = built.lib
    head = ([_P, _I, _P, _P, _I, _I, _I, _P, _P, _I, _P, _I, _P] + [_P] * 9
            + [_P, _P, _P, _P, _I, _F, _F, _I])
    lib.ptrt_path_bounce_bvh.argtypes = head + [_P] + [_I] * 4 + [_P]
    lib.ptrt_path_bounce_bvh_occupancy.argtypes = [_I] * 3 + [ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.ptrt_path_bounce_bvh, lib.ptrt_path_bounce_bvh_occupancy):
        fn.restype = ctypes.c_int
    return built


def _launch(cs, tables: BvhTables, o: V3, d: V3, thr: V3, key, depth, t_min, t_max,
            shadow_light) -> BounceOut:
    who = "path_bounce_bvh"
    device = o.x.device
    n = int(o.x.shape[0])
    if not bounce_bvh_ok(cs):
        raise ValueError(f"{who}: the scene fails bounce_bvh_ok")
    if isinstance(depth, int):
        depth = torch.full((n,), depth, dtype=torch.int32, device=device)
    nodes, n_nodes, _slots, ps, P, S, Q = tree_args(who, cs, device)
    psq = cs.n_planes + cs.n_spheres + cs.n_quads
    n_umats, n_lights = int(cs.mat_table.diffuse.shape[0]), cs.n_lights
    for name, t, size in (("psuid", tables.psuid, psq),
                          ("umat", tables.umat, _MAT_FIELDS * n_umats),
                          ("light", tables.light, 3 * n_lights)):
        _check(name, t, torch.float32, size, device, who)
    rays = (*o, *d, *thr)
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz", "tx", "ty", "tz"), rays):
        _check(name, t, torch.float32, n, device, who)
    _check("depth", depth, torch.int32, n, device, who)
    _check("key", key, torch.int32, n, device, who)

    out = torch.empty((_N_FIELDS, n), dtype=torch.float32, device=device)
    prim = torch.empty((n,), dtype=torch.int32, device=device)
    shadow = torch.empty((_N_SHADOW, n), dtype=torch.float32, device=device)
    if n > 0:
        lib = build().lib
        args = (nodes, n_nodes, slot16_arg(who, cs, device), ps, P, S, Q,
                tables.psuid.data_ptr(), tables.umat.data_ptr(), n_umats,
                tables.light.data_ptr(), n_lights, depth.data_ptr(),
                *(t.data_ptr() for t in rays), key.data_ptr(), out.data_ptr(), prim.data_ptr(),
                shadow.data_ptr(), n, float(t_min), float(t_max), int(bool(shadow_light)))
        plan = bounce_plan(cs, tables, smem_limit(device))
        grid = launch_grid(who, lib.ptrt_path_bounce_bvh_occupancy, plan, n, device)
        err = lib.ptrt_path_bounce_bvh(*args, lane_counter(device).data_ptr(), int(plan.stage),
                                       plan.depth_class, plan.smem_bytes, grid,
                                       torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{who}: kernel launch failed with cudaError {err}")
        path_bounce_bvh.launches += 1
    occluded = scene_any(cs, V3(shadow[0], shadow[1], shadow[2]),
                         V3(shadow[3], shadow[4], shadow[5]), t_min, shadow[6])
    return BounceOut(
        hit=out[0] > 0.5, killed=out[1] > 0.5, w_sky=out[2],
        w_nee=torch.where(occluded, 0.0, out[3]), rr_scale=out[4], s_thr=out[5], t_thr=out[6],
        new_org=V3(out[7], out[8], out[9]), new_dir=V3(out[10], out[11], out[12]), u=out[13],
        v=out[14], tex_id=out[15], mat_color=V3(out[16], out[17], out[18]), prim=prim,
    )


def path_bounce_bvh(cs, tables: BvhTables, o: V3, d: V3, thr: V3, key, depth, t_min=T_MIN,
                    t_max=T_MAX, shadow_light: bool = False) -> BounceOut:
    """One bounce for every ray of a BVH scene (per-lane ``depth``, int32
    ``key`` bits).

    Rays on a CUDA device go to K5 and then K4b, which raise on anything
    they do not take; rays on the CPU take ``path_bounce_plain``.
    ``tables`` is ``pack_bvh_tables(cs)`` on the rays' device."""
    dev = o.x.device
    if dev.type == "cuda":
        return _launch(cs, tables, o, d, thr, key, depth, t_min, t_max, shadow_light)
    if dev.type == "cpu":
        return path_bounce_plain(cs, o, d, thr, key, depth, t_min, t_max, shadow_light)
    raise ValueError(f"path_bounce_bvh: no kernel for device {dev}")


path_bounce_bvh.launches = 0  # kernel launches; the plain version does not count
