#!/usr/bin/env python3
"""The PyTorch + CUDA port's leaf-table occlusion walks, K10b (the scene
walk, ``bvh_leafmat.scene_any``) and K10d (the triangle walk with a carried
found mask, ``bvh_leafmat.tri_any``), against their first designs, on one
NVIDIA GPU: bit for bit on every lane, and timed in turns (new, first
design, first design, new) by device time per launch.

The ray sets are on config 5 (``MeshSceneBuilder(3, 3)``, 11,520
triangles), from ``chip_smoke.py``'s phase 19: 131,072 camera rays over the
1920x1080 frame, their secondary rays one plain bounce on, and rays from
those origins aimed at random points of the mesh (every one hits).

* the camera rays' light-sample shadow rays (as the mesh path makes them,
  ``chip_smoke.mesh_shadow``);
* the secondary rays with a per-ray limit about half of them reach;
* the aimed rays with limit 1e6 (every lane occluded);
* the shadow rays again with the tree reported 20 deep (the deep stack
  class);
* the secondary rays' limits with a tenth of the lanes ``+inf`` and a tenth
  ``<= 0``.

K10d runs each set twice: with no lane found, and with the found mask the
``quad`` route gives it (the plane/sphere/quad broadcast, ``_ps_any``).
K10a (the kept kernel, through its wrapper; redesigned since, see
``torch_scene_closest_first_design.py``) is held bit for bit against the
K10a of this commit on the camera, secondary and aimed rays.  Then K10b
against its redesigned twin, the persistent K4b (``bvh._fused_any``), and
K10d against the redesigned K4d (``bvh_paged.pages_any`` over the whole
tree), in turns, on the first three sets: the leaf table against
Möller–Trumbore on the same walk.  And
on every set, the kept leaf visit, which issues a batch's four t·det loads
only when one of its slots lies inside its triangle, against the visit that
issues all 19 loads together (``ALL_LOADS_ANY``, built from the current
sources with that visit in place of ``MatQuadLeaf::any``), bit for bit and
in turns.

The repository keeps no copy of the first designs.  Extract their sources
from the commit that last had them into a directory and pass it:

    mkdir -p .scratch/first_k10bd
    for f in bvh_leafmat.cu bvh_walk.cuh sweep.cuh; do
      git show 359e47e:path_tracing__ray_tracer_tpu_torch/csrc/$f > .scratch/first_k10bd/$f
    done
    python3 experiments/torch_leafmat_any_first_design.py .scratch/first_k10bd

They are built with the port's ``nvcc`` flags into ``DIR/build`` under
another library name, as is the variant; the first designs' kernels keep
their own symbols (``mat_scene_any_kernel``, ``mat_tri_any_kernel``), so
the profiler tells them from the redesign's (``mat_scene_any_persistent``,
``mat_tri_any_persistent``).  Each time is the kernel's device time per
launch (``torch_page_walks_first_design.device_ms``).  Prints the card's
name and power limit; exits non-zero when any lane differs.
"""
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "experiments"))

import chip_smoke as S  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.cuda import (  # noqa: E402
    build, bvh, bvh_leafmat, bvh_paged)
from path_tracing__ray_tracer_tpu_torch.ops.intersect import _CANDIDATES, _ps_any  # noqa: E402
from torch_ordered_any_and_leafmat_first_design import half_bound, leaf_sets  # noqa: E402
from torch_scene_closest_first_design import raw_fields  # noqa: E402
from torch_split_walks_first_design import in_turns  # noqa: E402

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
T_MIN = 1e-3
CSRC = ROOT / "path_tracing__ray_tracer_tpu_torch" / "csrc"

# The variant of MatQuadLeaf::any: a batch's 19 loads issued together, as
# the closest visit issues them, before its slots' tests; each slot's
# decision expression for expression the kept visit's, which issues t·det's
# four loads only for a batch with a slot inside its triangle.
ALL_LOADS_ANY = r"""  __device__ __forceinline__ bool any(float base, const Ray&, float t_min, float limit) const {
    const float* col0 = mat + (size_t)base / kLeafSize * 128;
    for (int k = 0; k < kLeafSize; k += kSlotBatch) {
      float4 v[19];
      load_uv(col0, k, v);
      load_t(col0, k, v);
#pragma unroll
      for (int j = 0; j < kSlotBatch; ++j) {
        float det, un, vn, s2;
        if (!uv_inside(v, j, det, un, vn, s2)) continue;
        const float td = t_det(v, j) * det;
        if (td > t_min * s2 && td < limit * s2) return true;
      }
    }
    return false;
  }
"""


def variant_sources(dst: Path) -> Path:
    """The current ``bvh_leafmat.cu`` and its headers in ``dst``, with
    ``MatQuadLeaf::any`` replaced by ``ALL_LOADS_ANY``."""
    dst.mkdir(parents=True, exist_ok=True)
    for f in ("bvh_leafmat.cu", "sweep.cuh"):
        (dst / f).write_text((CSRC / f).read_text())
    walk = (CSRC / "bvh_walk.cuh").read_text()
    quad = walk.index("struct MatQuadLeaf : MatLeaf {")
    start = walk.index("  __device__ __forceinline__ bool any(", quad)
    end = walk.index("    return false;\n  }\n", start) + len("    return false;\n  }\n")
    if not walk[end:].startswith("};\n"):  # the struct's last member
        raise SystemExit("bvh_walk.cuh: MatQuadLeaf::any not found where expected")
    (dst / "bvh_walk.cuh").write_text(walk[:start] + ALL_LOADS_ANY + walk[end:])
    return dst / "bvh_leafmat.cu"


def build_libs(src: Path):
    """Compile the first design's ``bvh_leafmat.cu`` (from ``src``) and the
    variant's, one ``nvcc`` each, both at once, and bind their occlusion
    entries."""
    out = src / "build"
    out.mkdir(exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name, source in (("first", src / "bvh_leafmat.cu"),
                         ("all_loads", variant_sources(out / "all_loads_src"))):
        lib_path = out / f"lib{name}_leafmat.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(source)]
        jobs[name] = (lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in jobs.items():
        log = proc.communicate()[0]
        print(f"[{name}] {S.ptxas_summary(log)}", flush=True)
        if proc.returncode:
            raise SystemExit(log)
        libs[name] = ctypes.CDLL(str(lib_path))
    print(f"[build] nvcc in parallel: {time.perf_counter() - t0:.2f} s wall", flush=True)
    first, all_loads = libs["first"], libs["all_loads"]
    first.ptrt_mat_scene_any.argtypes = ([_P, _I, _P, _L, _P, _I, _I, _I] + [_P] * 6
                                         + [_P, _I, _F, _P, _P])
    first.ptrt_mat_tri_any.argtypes = [_P, _I, _P, _L] + [_P] * 6 + [_P, _P, _I, _F, _P, _P]
    kept = bvh_leafmat.build().lib
    first.ptrt_mat_scene_closest.argtypes = ([_P, _I, _P, _L, _P, _I, _I, _I] + [_P] * 6
                                             + [_I, _I, _F, _F] + [_P] * 7 + [_P])
    for fn in (first.ptrt_mat_scene_any, first.ptrt_mat_tri_any, first.ptrt_mat_scene_closest):
        fn.restype = ctypes.c_int
    for name in ("ptrt_mat_scene_any", "ptrt_mat_scene_any_occupancy", "ptrt_mat_tri_any",
                 "ptrt_mat_tri_any_occupancy"):
        fn = getattr(all_loads, name)
        fn.argtypes, fn.restype = getattr(kept, name).argtypes, ctypes.c_int
    return first, all_loads


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _rays(o, d):
    return tuple(x.data_ptr() for x in (*o, *d))


def check(label, new, other, what="the first design") -> bool:
    """Are ``new()`` and ``other()`` equal bit for bit on every lane?  The
    persistent walks must leave the lane counter zero."""
    eq = S.same_bits(new(), other())
    torch.cuda.synchronize()
    print(f"[bits] {label}: bit-equal to {what} on every lane: {eq}", flush=True)
    if bvh.lane_counter(torch.device("cuda", 0)).any():
        raise SystemExit("the persistent walks left the lane counter nonzero")
    return eq


def first_scene_any(lib, cs, o, d, limit):
    n = o.x.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.x.device)
    b = cs.bvh
    err = lib.ptrt_mat_scene_any(
        b.nodes4.data_ptr(), b.nodes4.shape[0] // 32, b.leaf_mat.data_ptr(), b.leaf_mat.shape[1],
        b.ps_blob.data_ptr(), cs.n_planes, cs.n_spheres, cs.n_quads, *_rays(o, d),
        limit.data_ptr(), n, T_MIN, occ.data_ptr(), _stream())
    bvh._raise_on("first_scene_any", err)
    return occ


def first_tri_any(lib, cs, o, d, limit, found):
    n = o.x.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=o.x.device)
    b = cs.bvh
    err = lib.ptrt_mat_tri_any(
        b.nodes4.data_ptr(), b.nodes4.shape[0] // 32, b.leaf_mat.data_ptr(), b.leaf_mat.shape[1],
        *_rays(o, d), limit.data_ptr(), found.data_ptr(), n, T_MIN, out.data_ptr(), _stream())
    bvh._raise_on("first_tri_any", err)
    return out


def scene_closest_raw(lib, cs, o, d):
    """K10a's seven output fields from the first design's C entry in ``lib``
    (t_max 1e6)."""
    n = o.x.shape[0]
    out = torch.empty((6, n), dtype=torch.float32, device=o.x.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    t, u, v, nx, ny, nz = out
    b = cs.bvh
    err = lib.ptrt_mat_scene_closest(
        b.nodes4.data_ptr(), b.nodes4.shape[0] // 32, b.leaf_mat.data_ptr(), b.leaf_mat.shape[1],
        b.ps_blob.data_ptr(), cs.n_planes, cs.n_spheres, cs.n_quads, *_rays(o, d), n,
        bvh.gid_mask(cs), T_MIN, 1e6, t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), _stream())
    bvh._raise_on("scene_closest_raw", err)
    return t, prim, u, v, nx, ny, nz


def all_loads_scene_any(lib, cs, o, d, limit):
    """K10b's wrapper with the variant's library."""
    dev, n = o.x.device, o.x.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    plan = bvh_leafmat.scene_any_plan(cs)
    grid = bvh.launch_grid("all_loads.scene_any", lib.ptrt_mat_scene_any_occupancy, plan, n, dev)
    err = lib.ptrt_mat_scene_any(
        *bvh_leafmat.aligned_table_args("all_loads", cs, dev), *_rays(o, d), limit.data_ptr(), n,
        T_MIN, occ.data_ptr(), bvh.lane_counter(dev).data_ptr(), plan.depth_class,
        plan.smem_bytes, grid, _stream())
    bvh._raise_on("all_loads_scene_any", err)
    return occ


def all_loads_tri_any(lib, cs, o, d, limit, found):
    """K10d's wrapper with the variant's library."""
    dev, n = o.x.device, o.x.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    plan = bvh_leafmat.tri_plan(cs)
    grid = bvh.launch_grid("all_loads.tri_any", lib.ptrt_mat_tri_any_occupancy, plan, n, dev)
    err = lib.ptrt_mat_tri_any(
        *bvh_leafmat.aligned_table_args("all_loads", cs, dev)[:4], *_rays(o, d), limit.data_ptr(),
        found.data_ptr(), n, T_MIN, out.data_ptr(), bvh.lane_counter(dev).data_ptr(),
        plan.depth_class, grid, _stream())
    bvh._raise_on("all_loads_tri_any", err)
    return out


def any_sets(cs, cam, dev):
    """``{label: (cs, o, d, limit)}``: the five sets of the docstring."""
    n = S.N_RAYS
    (_, o, d, key, depth), (_, bo, bd, _bk, _bdp), (_, ao, ad, _ak, _adp) = leaf_sets(cs, cam, dev)
    so, sd, lim = S.mesh_shadow(cs, o, d, key, depth)
    deep = cs._replace(bvh=cs.bvh._replace(depth4=20))
    half = half_bound(cs, bo, bd, 41)
    lane = torch.arange(n, device=dev)
    mixed = torch.where(lane % 10 == 3, float("inf"), torch.where(
        lane % 10 == 7, torch.where(lane % 20 == 7, 0.0, -1.0), half))
    return {
        "shadow rays of the camera rays": (cs, so, sd, lim.contiguous()),
        "secondary rays, per-ray limit": (cs, bo, bd, half),
        "aimed rays, limit 1e6": (cs, ao, ad, torch.full((n,), 1e6, device=dev)),
        "shadow rays, stack class 32 (reported 20 deep)": (deep, so, sd, lim.contiguous()),
        "secondary rays, a tenth +inf and a tenth <= 0": (cs, bo, bd, mixed.contiguous()),
    }


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    S.phase_environment()
    S.phase_build()
    first, all_loads = build_libs(Path(argv[0]).resolve())
    dev = torch.device("cuda", 0)
    _scene, cam, cs = S.mesh_scene(dev)
    deep = cs._replace(bvh=cs.bvh._replace(depth4=20))
    lib = bvh_leafmat.build().lib
    grids = {k: bvh.launch_grid(k, occupancy, plan(cs), S.N_RAYS, dev) for k, occupancy, plan in (
        ("K10b", lib.ptrt_mat_scene_any_occupancy, bvh_leafmat.scene_any_plan),
        ("K10d", lib.ptrt_mat_tri_any_occupancy, bvh_leafmat.tri_plan))}
    print(f"[plans] config 5: depth4 {cs.bvh.depth4} -> K10b "
          f"{tuple(bvh_leafmat.scene_any_plan(cs))}, K10d {tuple(bvh_leafmat.tri_plan(cs))}; "
          f"reported 20 deep -> K10b {tuple(bvh_leafmat.scene_any_plan(deep))}, K10d "
          f"{tuple(bvh_leafmat.tri_plan(deep))}; planes/spheres/quads "
          f"{cs.n_planes}/{cs.n_spheres}/{cs.n_quads}; grids at {S.N_RAYS}: K10b {grids['K10b']}, "
          f"K10d {grids['K10d']} blocks of {bvh.WALK_THREADS} (first design "
          f"{-(-S.N_RAYS // 128)} of 128)", flush=True)
    ok = True
    timed, twins, visit_rows = {}, {}, {}
    for label, o, d, _key, _depth in leaf_sets(cs, cam, dev):
        with raw_fields():
            got = bvh_leafmat.scene_closest(cs, o, d, T_MIN, 1e6)
        want = scene_closest_raw(first, cs, o, d)
        eq = all(S.same_bits(a, b) for a, b in zip(got, want))
        print(f"[bits] K10a, {label}, t_max 1e6: all seven fields bit-equal to the first design "
              f"on every lane: {eq}", flush=True)
        ok &= eq
    sets = any_sets(cs, cam, dev)
    for k, (label, (c, o, d, lim)) in enumerate(sets.items()):
        care = lim > 0
        unfound = torch.zeros(lim.shape, dtype=torch.bool, device=dev)
        quad_found = _ps_any(c, o, d, T_MIN, lim, _CANDIDATES[:3]).contiguous()
        occ = bvh_leafmat.scene_any(c, o, d, T_MIN, lim)
        print(f"[set] {label}: {int(care.sum())} of {lim.numel()} rays need an answer, "
              f"{int(torch.isinf(lim).sum())} with limit +inf, occluded "
              f"{float(occ[care].float().mean()):.4f}; the quad route's found mask holds "
              f"{int(quad_found.sum())} lanes", flush=True)
        b_new = (lambda c=c, o=o, d=d, lim=lim: bvh_leafmat.scene_any(c, o, d, T_MIN, lim),
                 "mat_scene_any_persistent")
        b_first = (lambda c=c, o=o, d=d, lim=lim: first_scene_any(first, c, o, d, lim),
                   "mat_scene_any_kernel")
        b_all = (lambda c=c, o=o, d=d, lim=lim: all_loads_scene_any(all_loads, c, o, d, lim),
                 "mat_scene_any_persistent")
        row = f"K10b, {label}"
        ok &= check(row, b_new[0], b_first[0])
        ok &= check(f"{row}: all 19 loads together", b_new[0], b_all[0], "the kept visit")
        timed[row] = in_turns(row, b_new, b_first)
        visit_rows[row] = in_turns(f"{row}: kept visit against all 19 loads together", b_new,
                                   b_all)
        if k < 3:
            k4b = (lambda c=c, o=o, d=d, lim=lim: bvh._fused_any(c, o, d, T_MIN, lim),
                   "bvh_any_persistent")
            twins[row] = in_turns(f"{row}: against the persistent K4b", b_new, k4b)
        for what, found in (("no lane found", unfound), ("the quad route's found", quad_found)):
            row = f"K10d, {label}, {what}"
            d_new = (lambda c=c, o=o, d=d, lim=lim, f=found: bvh_leafmat.tri_any(
                c, o, d, T_MIN, lim, f), "mat_tri_any_persistent")
            d_first = (lambda c=c, o=o, d=d, lim=lim, f=found: first_tri_any(
                first, c, o, d, lim, f), "mat_tri_any_kernel")
            ok &= check(row, d_new[0], d_first[0])
            timed[row] = in_turns(row, d_new, d_first)
            if found is unfound:
                d_all = (lambda c=c, o=o, d=d, lim=lim, f=found: all_loads_tri_any(
                    all_loads, c, o, d, lim, f), "mat_tri_any_persistent")
                ok &= check(f"{row}: all 19 loads together", d_new[0], d_all[0],
                            "the kept visit")
                visit_rows[row] = in_turns(
                    f"{row}: kept visit against all 19 loads together", d_new, d_all)
            if k < 3:
                k4d = (lambda c=c, o=o, d=d, lim=lim, f=found: bvh_paged.pages_any(
                    c, o, d, T_MIN, lim, f), "pages_any_persistent")
                twins[row] = in_turns(f"{row}: against the redesigned K4d", d_new, k4d)
    print(S.card_line())
    for name, rows in (("new / first design", timed), ("K10b / K4b, K10d / K4d twins", twins),
                       ("kept visit / all 19 loads together", visit_rows)):
        ratios = [a / b for a, b in rows.values()]
        print(f"[summary] {name}: {len(rows)} rows in turns, {min(ratios):.3f}-"
              f"{max(ratios):.3f}x (mean of rows {statistics.mean(ratios):.3f})")
    print(f"[summary] every lane bit-equal to the first designs and the variant: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
