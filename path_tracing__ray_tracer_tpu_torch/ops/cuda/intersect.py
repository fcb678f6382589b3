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

A CUDA tensor goes to the kernel (the wrapper raises on what the kernel
does not take); a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..intersect import scene_hit, scene_hit_any
from ..v3 import V3
from .bounce import _SMEM_LIMIT, _check, blob_layout


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
    built.lib.ptrt_closest_hit.argtypes = (
        [_P, _I, _I, _I, _I] + [_P] * 6 + [_I, _F, _F] + [_P] * 7 + [_P])
    built.lib.ptrt_any_hit.argtypes = [_P, _I, _I, _I, _I] + [_P] * 7 + [_I, _F, _P, _P]
    built.lib.ptrt_closest_hit.restype = built.lib.ptrt_any_hit.restype = ctypes.c_int
    return built


def _checked_rays(who, cs, blob, ro: V3, rd: V3):
    device = ro.x.device
    n = int(ro.x.shape[0])
    layout = blob_layout(cs)
    _check("blob", blob, torch.float32, layout.size, device, who)
    if 4 * layout.size > _SMEM_LIMIT:
        raise ValueError(f"{who}: the scene blob needs {4 * layout.size} B of shared memory, "
                         f"more than the kernel's {_SMEM_LIMIT} B")
    rays = (*ro, *rd)
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz"), rays):
        _check(name, t, torch.float32, n, device, who)
    return device, n, layout, rays


def _raise_on(who, err):
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed with cudaError {err}")


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
    device, n, L, rays = _checked_rays("closest_hit", cs, blob, ro, rd)
    fn = build().lib.ptrt_closest_hit
    out = torch.empty((6, n), dtype=torch.float32, device=device)
    prim = torch.empty((n,), dtype=torch.int32, device=device)
    t, nx, ny, nz, u, v = out
    err = fn(blob.data_ptr(), L.n_planes, L.n_spheres, L.n_quads, L.n_tris,
             *(r.data_ptr() for r in rays), n, float(t_min), float(t_max), t.data_ptr(),
             prim.data_ptr(), nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), u.data_ptr(),
             v.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
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
    device, n, L, rays = _checked_rays("any_hit", cs, blob, ro, rd)
    if not isinstance(t_max, torch.Tensor):
        t_max = torch.full((n,), float(t_max), dtype=torch.float32, device=device)
    _check("t_max", t_max, torch.float32, n, device, "any_hit")
    fn = build().lib.ptrt_any_hit
    occ = torch.empty((n,), dtype=torch.bool, device=device)
    err = fn(blob.data_ptr(), L.n_planes, L.n_spheres, L.n_quads, L.n_tris,
             *(r.data_ptr() for r in rays), t_max.data_ptr(), n, float(t_min), occ.data_ptr(),
             torch.cuda.current_stream(device).cuda_stream)
    _raise_on("any_hit", err)
    any_hit.launches += 1
    return occ


closest_hit.launches = 0  # kernel launches; the plain version does not count
any_hit.launches = 0
