"""One fused step of the path tracer's regeneration scheduler (the "pipe"
mode): the CUDA kernel ``csrc/path_step.cu`` (K7) and its plain torch
version.

The kernel replaces the JAX package's
``ops/pallas/bounce_pallas.py::_path_step_kernel`` (entered there through
``path_step_pallas``).  One call runs the glue of the previous bounce's
record (base colour, contribution, retirement, park, item advance, camera
ray and key of a regenerated item) and then the bounce of the new rays,
and returns the next record.  The caller gathers the record's texel
(``atlas[max(idx, 0)]``) between calls and folds the parks into its
accumulator; ``models/experimental.py`` drives it.

* :class:`StepStatics`, :class:`StepRec`, :func:`pack_tex_blob`: the
  JAX package's names for the chunk's constants, the per-lane record carried
  between calls, and the texture table;
* :func:`step_plan`: the shared memory of a launch (K1's tables, which each
  resident block copies once: ``bounce.sweep_plan``); the grid of its
  persistent blocks is ``ops/cuda/bvh.launch_grid``'s, their lanes taken
  from ``bvh.lane_counter`` as K1's are;
* :func:`path_step`: the wrapper; a CUDA tensor goes to the kernel (or the
  wrapper raises), a CPU tensor takes :func:`path_step_plain`, the same
  function as plain torch ops (the glue of ``_path_step_kernel`` term for
  term, then ``path_bounce_plain``).

Both return ``(rec', o, d, thr', psum', key', depth', s', ploc', ux', uy',
item, park)`` as ``path_step_pallas`` does: ``o``/``d`` are the rays this
call traced, ``item`` the finished item of each lane (``ns`` when none) and
``park`` its path sum (0 when none).  Integer lane state is int32; ``key``
holds the RNG key's uint32 bits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import rng
from ..camera import generate_rays
from ..texture import _unpack_rgb
from ..v3 import V3
from .bounce import (_SKY, SweepPlan, _check, _check_tables, blob_layout, path_bounce_plain,
                     sweep_plan)
from .texture import texel_index

_JITTER = {"center": 0, "diagonal": 1, "independent": 2}


class StepStatics(NamedTuple):
    """The constants of one chunk's fused steps (the JAX package's static
    kernel parameters; the scene layout comes from the scene itself)."""
    n_tex: int
    tex_on: bool  # False when no primitive is textured: every record untextured
    t_min: float
    t_max: float
    shadow_light: bool
    jitter: str  # "center" | "diagonal" | "independent"
    width: int
    height: int
    total: int  # width · height
    stride: int  # the item stride (scheduler's golden-ratio shuffle)
    n_pix: int
    ns: int  # samples of the chunk
    max_depth: int


class StepRec(NamedTuple):
    """The per-lane bounce record carried between fused steps.  ``idx`` is
    the flat atlas texel index of the hit (−1 untextured)."""
    idx: torch.Tensor  # int32
    hit: torch.Tensor  # f32 0/1
    kill: torch.Tensor  # f32 0/1
    wnee: torch.Tensor
    rrs: torch.Tensor
    sthr: torch.Tensor
    tthr: torch.Tensor
    no: V3  # scatter origin
    nd: V3  # scatter direction
    mc: V3  # material colour (the base where untextured)


def pack_tex_blob(cs) -> torch.Tensor:
    """The texture table of the step kernel: (3·T,) int32 [widths | heights | offsets]."""
    return torch.cat([cs.tex_width, cs.tex_height, cs.tex_offset]).to(torch.int32).contiguous()


def step_plan(cs, limit: int) -> SweepPlan:
    """The dynamic shared memory of a K7 launch on ``cs``, on a card whose
    blocks may take ``limit`` bytes (``ops/cuda/bvh.smem_limit``): K1's
    tables, the records, materials and light samples of ``cs``
    (``bounce.sweep_plan``).  Raises when they do not fit."""
    layout = blob_layout(cs)
    return sweep_plan("path_step", layout[:4], int(cs.materials.diffuse.shape[0]), cs.n_lights,
                      limit)


# ---- plain version -------------------------------------------------------------
def _advance(st: StepStatics, done, ploc, ux, uy):
    """``ploc += stride (mod n_pix)`` and its pixel by two fixed deltas and
    one carry or borrow, on the ``done`` lanes."""
    back = st.n_pix - st.stride
    pl2 = ploc + st.stride
    wrap = pl2 >= st.n_pix
    pl2 = torch.where(wrap, pl2 - st.n_pix, pl2)
    ax = torch.where(wrap, ux - back % st.width, ux + st.stride % st.width)
    ay = torch.where(wrap, uy - back // st.width, uy + st.stride // st.width)
    ay = torch.where(ax >= st.width, ay + 1, torch.where(ax < 0, ay - 1, ay))
    ax = torch.where(ax >= st.width, ax - st.width, torch.where(ax < 0, ax + st.width, ax))
    return (torch.where(done, pl2, ploc), torch.where(done, ax, ux), torch.where(done, ay, uy))


def path_step_plain(cs, st: StepStatics, tables, cam12, scal, rec: StepRec, texel, thr: V3,
                    psum: V3, key, depth, s, ploc, ux, uy):
    """One fused step in plain torch ops (``tables`` is unused: it is
    :func:`path_step`'s)."""
    pix0, seed, sample_base = scal
    zero = torch.zeros_like(rec.wnee)
    zeros = V3(zero, zero, zero)
    # ---- glue: the previous record's base colour, contribution, retirement
    hitb = rec.hit > 0.5
    wsky = torch.where(hitb, 0.0, _SKY)
    base = V3.where(rec.idx >= 0, _unpack_rgb(texel), rec.mc)
    active = s < st.ns
    psum = psum + V3.where(active, thr * wsky + thr * (base * rec.wnee), zeros)
    live = active & hitb & (rec.kill <= 0.5)
    thr = V3.where(live, thr * rec.rrs * (base * rec.tthr + rec.sthr), thr)
    live = live & (thr.max_component() >= 0.001)
    ndepth = depth + 1
    live = live & (ndepth < st.max_depth)
    done = active & ~live

    # ---- item advance, the camera ray and key of a regenerated item
    s2 = s + done.to(torch.int32)
    ploc, ux, uy = _advance(st, done, ploc, ux, uy)
    idxg = pix0 + ploc
    keyn = rng.ray_key(seed, idxg, sample_base + s2)
    if st.jitter == "center":
        r1 = r2 = 0.5
    else:
        r1 = rng.uniform(keyn, st.max_depth, 0)
        r2 = r1 if st.jitter == "diagonal" else rng.uniform(keyn, st.max_depth, 1)
    over = idxg > st.total - 1
    xs = torch.where(over, float((st.total - 1) % st.width), ux.to(torch.float32))
    ys = torch.where(over, float((st.total - 1) // st.width), uy.to(torch.float32))
    o_cam, d_cam = generate_rays(cam12, (xs + r1) / st.width, (ys + r2) / st.height)
    regen = done & (s2 < st.ns)
    o = V3.where(regen, o_cam, rec.no)
    d = V3.where(regen, d_cam, rec.nd)
    one = torch.ones_like(zero)
    thr = V3.where(regen, V3(one, one, one), thr)
    key = torch.where(regen, keyn, key)
    depth2 = torch.where(live, ndepth, 0).to(torch.int32)
    item = torch.where(done, s, st.ns).to(torch.int32)
    park = V3.where(done, psum, zeros)
    psum = V3.where(done, zeros, psum)

    # ---- bounce the new rays
    out = path_bounce_plain(cs, o, d, thr, key, depth2, st.t_min, st.t_max, st.shadow_light)
    idx = torch.full_like(s2, -1)
    if st.tex_on and st.n_tex > 0:
        idx = torch.where(out.tex_id >= 0.0, texel_index(cs, out.tex_id, out.u, out.v), -1)
    rec2 = StepRec(idx=idx.to(torch.int32), hit=out.hit.to(torch.float32),
                   kill=out.killed.to(torch.float32), wnee=out.w_nee, rrs=out.rr_scale,
                   sthr=out.s_thr, tthr=out.t_thr, no=out.new_org, nd=out.new_dir,
                   mc=out.mat_color)
    return (rec2, o, d, thr, psum, key, depth2, s2, ploc, ux, uy, item, park)


# ---- the kernel ------------------------------------------------------------------
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IN_FIELDS = ("idx", "texel", "hit", "kill", "wnee", "rrs", "sthr", "tthr", "nox", "noy", "noz",
              "ndx", "ndy", "ndz", "mr", "mg", "mb", "thx", "thy", "thz", "psx", "psy", "psz",
              "key", "depth", "s", "ploc", "ux", "uy")


class _StepIn(ctypes.Structure):
    _fields_ = [(f, _P) for f in _IN_FIELDS]


class _StepConsts(ctypes.Structure):
    _fields_ = [(f, _I) for f in ("width", "height", "total", "stride", "n_pix", "ns",
                                  "max_depth", "jitter", "pix0", "sample_base")] + [
        ("seed", ctypes.c_uint32)]


def build():
    """Compile (once per source hash) and load ``csrc/path_step.cu``."""
    from . import build as _build

    built = _build.load("path_step")
    lib = built.lib
    lib.ptrt_path_step.argtypes = [_P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _I, _P, _StepIn,
                                   _StepConsts, _P, _P, _I, _F, _F, _I, _P, _I, _I, _P]
    lib.ptrt_path_step_occupancy.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.ptrt_path_step, lib.ptrt_path_step_occupancy):
        fn.restype = ctypes.c_int
    return built


def _launch(cs, st, tables, cam12, scal, rec, texel, thr, psum, key, depth, s, ploc, ux, uy):
    from .bvh import lane_counter, launch_grid, smem_limit

    device = thr.x.device
    n = int(thr.x.shape[0])
    blob, mat_blob, light_blob, tex_blob = tables
    layout, n_mats, n_lights = _check_tables("path_step", cs, blob, mat_blob, light_blob, device)
    _check("tex_blob", tex_blob, torch.int32, 3 * cs.n_textures, device, "path_step")
    _check("cam12", cam12, torch.float32, 12, device, "path_step")
    lanes = (rec.idx, texel, rec.hit, rec.kill, rec.wnee, rec.rrs, rec.sthr, rec.tthr, *rec.no,
             *rec.nd, *rec.mc, *thr, *psum, key, depth, s, ploc, ux, uy)
    for k, (name, t) in enumerate(zip(_IN_FIELDS, lanes)):
        _check(name, t, torch.float32 if 2 <= k < 23 else torch.int32, n, device, "path_step")
    pix0, seed, sample_base = scal
    consts = _StepConsts(st.width, st.height, st.total, st.stride, st.n_pix, st.ns, st.max_depth,
                         _JITTER[st.jitter], int(pix0), int(sample_base), int(seed) & 0xFFFFFFFF)
    plan = step_plan(cs, smem_limit(device))
    fout = torch.empty((30, n), dtype=torch.float32, device=device)
    iout = torch.empty((8, n), dtype=torch.int32, device=device)
    if n == 0:
        return _outputs(fout, iout)
    lib = build().lib
    grid = launch_grid("path_step", lib.ptrt_path_step_occupancy, plan, n, device)
    err = lib.ptrt_path_step(
        blob.data_ptr(), layout.n_planes, layout.n_spheres, layout.n_quads, layout.n_tris,
        mat_blob.data_ptr(), n_mats, light_blob.data_ptr(), n_lights, tex_blob.data_ptr(),
        st.n_tex if st.tex_on else 0, cam12.data_ptr(),
        _StepIn(*(t.data_ptr() for t in lanes)), consts, fout.data_ptr(), iout.data_ptr(), n,
        float(st.t_min), float(st.t_max), int(bool(st.shadow_light)),
        lane_counter(device).data_ptr(), plan.smem_bytes, grid,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"path_step: kernel launch failed with cudaError {err}")
    path_step.launches += 1
    return _outputs(fout, iout)


def _outputs(f, i):
    """``path_step``'s outputs from the kernel's (30, N) float and (8, N)
    int rows."""
    rec2 = StepRec(idx=i[0], hit=f[0], kill=f[1], wnee=f[2], rrs=f[3], sthr=f[4], tthr=f[5],
                   no=V3(f[6], f[7], f[8]), nd=V3(f[9], f[10], f[11]), mc=V3(f[12], f[13], f[14]))
    return (rec2, V3(f[15], f[16], f[17]), V3(f[18], f[19], f[20]), V3(f[21], f[22], f[23]),
            V3(f[24], f[25], f[26]), i[1], i[2], i[3], i[4], i[5], i[6], i[7],
            V3(f[27], f[28], f[29]))


def path_step(cs, st: StepStatics, tables, cam12, scal, rec: StepRec, texel, thr: V3, psum: V3,
              key, depth, s, ploc, ux, uy):
    """One fused scheduler step for every lane.

    ``tables`` is ``(pack_scene_blob, pack_mat_blob, pack_light_blob,
    pack_tex_blob)`` of ``cs``, ``cam12`` the packed camera and ``scal``
    ``(pix0, seed, sample_base)``, all on the lanes' device.  Lanes on a
    CUDA device go to the kernel, which raises on anything it does not take;
    lanes on the CPU take :func:`path_step_plain`.
    """
    dev = thr.x.device
    if dev.type == "cuda":
        return _launch(cs, st, tables, cam12, scal, rec, texel, thr, psum, key, depth, s, ploc,
                       ux, uy)
    if dev.type == "cpu":
        return path_step_plain(cs, st, tables, cam12, scal, rec, texel, thr, psum, key, depth, s,
                               ploc, ux, uy)
    raise ValueError(f"path_step: no kernel for device {dev}")


path_step.launches = 0  # kernel launches; the plain version does not count
