"""Standalone scene intersection: the CUDA kernels ``csrc/intersect.cu`` and
their plain torch versions.

The kernels replace the JAX package's
``ops/pallas/intersect_pallas.py::_closest_kernel`` (entered there through
``closest_hit_pallas``) and ``::_any_kernel`` (``any_hit_pallas``), the
brute-force route that the JAX ``scene_hit`` / ``scene_hit_any`` take for
small scenes.  The oracle renderer (``models/whitted_oracle.py``) calls them;
the plain ``ops/intersect.scene_hit`` stays plain, so the plain versions of
the bounce kernels stay plain on the card too.

* :func:`closest_hit` returns the :class:`ClosestRecord` of the TPU kernel:
  ``t`` (the bound on a miss), ``prim`` (int32, −1 on a miss), the shading
  normal (zeros on a miss), ``u`` and ``v`` (zeros on a miss; triangle UVs
  always interpolated).
* :func:`any_hit` returns a bool occlusion mask for a per-ray (or scalar)
  ``t_max``.

Both kernels run in persistent blocks that copy the scene into shared
memory once, as the 16-byte records of ``bounce.pack_scene_rec16``
(``bounce.sweep_plan`` with no materials or lights sizes them), and take
their later lanes from the stream's lane counter
(``ops/cuda/bvh.lane_counter``, ``launch_grid``).

A CUDA tensor goes to the kernel (the wrapper raises on what the kernel
does not take); a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..intersect import scene_hit, scene_hit_any
from ..v3 import V3
from .bounce import _check, blob_layout, sweep_plan


class ClosestRecord(NamedTuple):
    t: torch.Tensor  # f32, the bound on a miss
    prim: torch.Tensor  # int32 global primitive id, -1 on a miss
    normal: V3  # shading normal (quads/triangles flipped toward the ray); 0 on a miss
    u: torch.Tensor
    v: torch.Tensor

    @property
    def hit(self) -> torch.Tensor:
        return self.prim >= 0


# ---- plain versions -------------------------------------------------------------
def closest_hit_plain(cs, ro: V3, rd: V3, t_min: float, t_max: float) -> ClosestRecord:
    """``ops/intersect.scene_hit`` reduced to the kernel's record."""
    h = scene_hit(cs, ro, rd, t_min, t_max)
    zero = torch.zeros_like(h.t)
    normal = V3.where(h.hit, h.normal, V3(zero, zero, zero))
    return ClosestRecord(t=h.t, prim=h.prim, normal=normal, u=h.u, v=h.v)


def any_hit_plain(cs, ro: V3, rd: V3, t_min: float, t_max) -> torch.Tensor:
    """``ops/intersect.scene_hit_any``: is anything hit in ``(t_min, t_max)``?"""
    return scene_hit_any(cs, ro, rd, t_min, t_max)


# ---- the kernels ------------------------------------------------------------------
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build():
    """Compile (once per source hash) and load ``csrc/intersect.cu``."""
    from . import build as _build

    built = _build.load("intersect")
    lib = built.lib
    lib.ptrt_closest_hit.argtypes = (
        [_P, _I, _I, _I, _I] + [_P] * 6 + [_I, _F, _F] + [_P] * 7 + [_P, _I, _I, _P])
    lib.ptrt_any_hit.argtypes = [_P, _I, _I, _I, _I] + [_P] * 7 + [_I, _F, _P, _P, _I, _I, _P]
    for occupancy in (lib.ptrt_closest_hit_occupancy, lib.ptrt_any_hit_occupancy):
        occupancy.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.ptrt_closest_hit, lib.ptrt_any_hit, lib.ptrt_closest_hit_occupancy,
               lib.ptrt_any_hit_occupancy):
        fn.restype = ctypes.c_int
    return built


def _checked_rays(who, cs, blob, ro: V3, rd: V3):
    device = ro.x.device
    n = int(ro.x.shape[0])
    layout = blob_layout(cs)
    _check("blob", blob, torch.float32, layout.size, device, who)
    from .bvh import smem_limit

    plan = sweep_plan(who, layout[:4], 0, 0, smem_limit(device))  # the records alone
    rays = (*ro, *rd)
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz"), rays):
        _check(name, t, torch.float32, n, device, who)
    return device, n, layout, plan, rays


def _raise_on(who, err):
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed with cudaError {err}")


def _launch_args(who, occupancy, plan, n, device):
    """The trailing arguments of a launch: lane counter, shared bytes, grid
    and stream."""
    from .bvh import lane_counter, launch_grid

    grid = launch_grid(who, occupancy, plan, n, device)
    return (lane_counter(device).data_ptr(), plan.smem_bytes, grid,
            torch.cuda.current_stream(device).cuda_stream)


def closest_hit(cs, blob, ro: V3, rd: V3, t_min: float, t_max: float) -> ClosestRecord:
    """Closest hit of every ray in ``(t_min, t_max)`` (scalar bound).

    Rays on a CUDA device go to the kernel; rays on the CPU take
    :func:`closest_hit_plain`.  ``blob`` is ``pack_scene_blob(cs)`` on the
    rays' device.
    """
    dev = ro.x.device
    if dev.type == "cpu":
        return closest_hit_plain(cs, ro, rd, t_min, t_max)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit: no kernel for device {dev}")
    device, n, L, plan, rays = _checked_rays("closest_hit", cs, blob, ro, rd)
    out = torch.empty((6, n), dtype=torch.float32, device=device)
    prim = torch.empty((n,), dtype=torch.int32, device=device)
    t, nx, ny, nz, u, v = out
    if n == 0:
        return ClosestRecord(t=t, prim=prim, normal=V3(nx, ny, nz), u=u, v=v)
    lib = build().lib
    err = lib.ptrt_closest_hit(
        blob.data_ptr(), L.n_planes, L.n_spheres, L.n_quads, L.n_tris,
        *(r.data_ptr() for r in rays), n, float(t_min), float(t_max), t.data_ptr(),
        prim.data_ptr(), nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), u.data_ptr(), v.data_ptr(),
        *_launch_args("closest_hit", lib.ptrt_closest_hit_occupancy, plan, n, device))
    _raise_on("closest_hit", err)
    closest_hit.launches += 1
    return ClosestRecord(t=t, prim=prim, normal=V3(nx, ny, nz), u=u, v=v)


def any_hit(cs, blob, ro: V3, rd: V3, t_min: float, t_max) -> torch.Tensor:
    """Bool mask: is any primitive hit in ``(t_min, t_max)``?  ``t_max`` is
    per ray, or a scalar that is broadcast (as the JAX wrapper does).

    Rays on a CUDA device go to the kernel; rays on the CPU take
    :func:`any_hit_plain`.
    """
    dev = ro.x.device
    if dev.type == "cpu":
        return any_hit_plain(cs, ro, rd, t_min, t_max)
    if dev.type != "cuda":
        raise ValueError(f"any_hit: no kernel for device {dev}")
    device, n, L, plan, rays = _checked_rays("any_hit", cs, blob, ro, rd)
    if not isinstance(t_max, torch.Tensor):
        t_max = torch.full((n,), float(t_max), dtype=torch.float32, device=device)
    _check("t_max", t_max, torch.float32, n, device, "any_hit")
    occ = torch.empty((n,), dtype=torch.bool, device=device)
    if n == 0:
        return occ
    lib = build().lib
    err = lib.ptrt_any_hit(
        blob.data_ptr(), L.n_planes, L.n_spheres, L.n_quads, L.n_tris,
        *(r.data_ptr() for r in rays), t_max.data_ptr(), n, float(t_min), occ.data_ptr(),
        *_launch_args("any_hit", lib.ptrt_any_hit_occupancy, plan, n, device))
    _raise_on("any_hit", err)
    any_hit.launches += 1
    return occ


closest_hit.launches = 0  # kernel launches; the plain version does not count
any_hit.launches = 0
