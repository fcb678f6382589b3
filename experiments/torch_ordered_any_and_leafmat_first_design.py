#!/usr/bin/env python3
"""The PyTorch + CUDA port's ordered BVH2 occlusion walk (K4e) and its
leaf-table closest walk (K10c) against their first designs, on one NVIDIA
GPU: bit for bit on every lane, and timed in turns (new, first design,
first design, new) by device time per launch.

The ray sets are ``chip_smoke.py``'s phases 19 and 22 on config 5
(``MeshSceneBuilder(3, 3)``, 11,520 triangles): 131,072 camera rays over
the 1920x1080 frame, their secondary rays one plain bounce on, and rays
from those origins aimed at random points of the mesh (every one hits).

* K4e ordered occlusion: the camera rays' light-sample shadow rays (as the
  mesh path makes them, ``chip_smoke.mesh_shadow``), the secondary rays
  with a per-ray limit about half of them reach, the aimed rays with limit
  1e6 (every lane occluded); the shadow rays again with the tree reported
  100 levels deep (the deep stack class); the 190-deep BVH2 chain of
  ``tests/torch_chain.py`` at 4,133 and 131,072 rays, and at 131,072 with
  the lanes shuffled (its deep rays are the first third of the lanes).
  The skip-link occlusion walk (``bvh2_any_skiplink_persistent`` since its
  own redesign) is held bit for bit against that commit's on the same sets.
* K10c: each set with the split route's seed record (``t_max`` 1e6, no
  winner) and with a per-ray bound about half of the hits lie beyond; then
  K10c against its redesigned twin K4c (``bvh_paged.pages_closest``) in
  turns, the leaf table against Möller–Trumbore on the same walk.

The repository keeps no copy of the first designs.  Extract their sources
from the commit that last had them into a directory and pass it:

    mkdir -p .scratch/first_k4e_k10c
    for f in bvh2_walk.cu bvh_leafmat.cu bvh_walk.cuh sweep.cuh; do
      git show 762ff5c:path_tracing__ray_tracer_tpu_torch/csrc/$f > .scratch/first_k4e_k10c/$f
    done
    python3 experiments/torch_ordered_any_and_leafmat_first_design.py .scratch/first_k4e_k10c

They are built with the port's ``nvcc`` flags into ``DIR/build`` under
other library names; their kernels keep their own symbols
(``bvh2_any_kernel``, ``mat_tri_closest_kernel``), so the profiler tells
them from the redesign's (``bvh2_any_persistent``,
``mat_tri_closest_persistent``).  Each time is the kernel's device time per
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
sys.path.insert(1, str(ROOT / "tests"))

import chip_smoke as S  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.cuda import (  # noqa: E402
    build, bvh, bvh2, bvh_leafmat, bvh_paged)
from path_tracing__ray_tracer_tpu_torch.ops.intersect import ClosestRecord  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3  # noqa: E402
from torch_chain import chain_rays, chain_scene  # noqa: E402
from torch_split_walks_first_design import in_turns  # noqa: E402

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
T_MIN = 1e-3


def build_first(src: Path):
    """Compile the first design's ``bvh2_walk.cu`` and ``bvh_leafmat.cu``,
    one ``nvcc`` each, both at once, and bind their occlusion and K10c
    entries."""
    out = src / "build"
    out.mkdir(exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name, source in (("bvh2", "bvh2_walk.cu"), ("leafmat", "bvh_leafmat.cu")):
        lib_path = out / f"libfirst_{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src / source)]
        jobs[name] = (lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in jobs.items():
        log = proc.communicate()[0]
        print(f"[first] {name}: {S.ptxas_summary(log)}", flush=True)
        if proc.returncode:
            raise SystemExit(log)
        libs[name] = ctypes.CDLL(str(lib_path))
    print(f"[first] nvcc in parallel: {time.perf_counter() - t0:.2f} s wall", flush=True)
    walk2, mat = libs["bvh2"], libs["leafmat"]
    walk2.ptrt_bvh2_any.argtypes = [_P, _I, _P] + [_P] * 6 + [_P, _I, _I, _F, _P, _P]
    mat.ptrt_mat_tri_closest.argtypes = ([_P, _I, _P, _L, _I, _I] + [_P] * 6 + [_P] * 7
                                         + [_I, _F] + [_P] * 7 + [_P])
    walk2.ptrt_bvh2_any.restype = mat.ptrt_mat_tri_closest.restype = ctypes.c_int
    return walk2, mat


def _stream():
    return torch.cuda.current_stream().cuda_stream


def fields(x):
    """The tensors of an occlusion mask or a closest record, flat."""
    if isinstance(x, torch.Tensor):
        return (x,)
    return (x.t, x.prim, x.u, x.v, *x.normal)


def check(label, new, first) -> bool:
    """Are ``new()`` and ``first()`` equal bit for bit on every lane and
    field?  The persistent walks must leave the lane counter zero."""
    got, want = fields(new()), fields(first())
    eq = len(got) == len(want) and all(S.same_bits(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()
    print(f"[bits] {label}: bit-equal to the first design on every lane: {eq}", flush=True)
    if bvh.lane_counter(torch.device("cuda", 0)).any():
        raise SystemExit("the persistent walks left the lane counter nonzero")
    return eq


def first_any(lib, cs, o, d, limit, ordered: bool):
    n = o.x.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.x.device)
    b = cs.bvh
    err = lib.ptrt_bvh2_any(b.tree2.data_ptr(), b.tree2.shape[0] // 8, b.slot_rec.data_ptr(),
                            *(x.data_ptr() for x in (*o, *d)), limit.data_ptr(), n, int(ordered),
                            T_MIN, occ.data_ptr(), _stream())
    bvh._raise_on("first_any", err)
    return occ


def _record_out(n, dev):
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    t, u, v, nx, ny, nz = out
    return ClosestRecord(t, prim, u, v, V3(nx, ny, nz))


def _record_args(rec):
    return (rec.t, rec.prim, rec.u, rec.v, *rec.normal)


def first_tri_closest(lib, cs, o, d, seed):
    n = o.x.shape[0]
    got = _record_out(n, o.x.device)
    b = cs.bvh
    err = lib.ptrt_mat_tri_closest(
        b.nodes4.data_ptr(), b.nodes4.shape[0] // 32, b.leaf_mat.data_ptr(),
        b.leaf_mat.shape[1], cs.n_planes + cs.n_spheres + cs.n_quads, bvh.gid_mask(cs),
        *(x.data_ptr() for x in (*o, *d)), *(x.data_ptr() for x in _record_args(seed)), n, T_MIN,
        *(x.data_ptr() for x in _record_args(got)), _stream())
    bvh._raise_on("first_tri_closest", err)
    return got


def leaf_sets(cs, cam, dev):
    """phase 19's three ray sets as ``(label, o, d, key, depth)``."""
    camera = S.camera_state(cs, cam, S.N_RAYS, dev, S.M_WIDTH, S.M_HEIGHT, S.M_DEPTH)
    bo, bd, _t, bkey, bdepth = S.advance_plain(cs, camera, 1)
    ao, ad, akey, adepth = S.aimed_rays(cs, bo, bkey)
    return (("camera rays", camera[0], camera[1], camera[3], camera[4]),
            ("secondary rays", bo, bd, bkey, bdepth), ("aimed rays", ao, ad, akey, adepth))


def half_bound(cs, o, d, seed):
    """A per-ray bound about half of the hits lie beyond: the plain closest
    hit's ``t`` times a uniform [0.5, 1.5)."""
    want_t, _ = tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, T_MIN, 1e6)
    u = torch.rand(o.x.shape[0], generator=torch.Generator(device=o.x.device).manual_seed(seed),
                   device=o.x.device)
    return (want_t * (0.5 + u)).contiguous()


def seed_record(bound):
    n, dev = bound.shape[0], bound.device
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    return ClosestRecord(bound.contiguous(), torch.full((n,), -1, dtype=torch.int32, device=dev),
                         zero, zero, V3(zero, zero, zero))


def any_rows(lib2, cs, o, d, limit, label):
    """``{label: (new, first, skip-link new, skip-link first)}``, each
    ``(call, symbol)``."""
    return {f"K4e ordered occlusion, {label}": (
        (lambda: bvh2.any_ordered(cs, o, d, T_MIN, limit), "bvh2_any_persistent"),
        (lambda: first_any(lib2, cs, o, d, limit, True), "bvh2_any_kernel"),
        (lambda: bvh2.any_skiplink(cs, o, d, T_MIN, limit), "bvh2_any_skiplink_persistent"),
        (lambda: first_any(lib2, cs, o, d, limit, False), "bvh2_any_kernel"))}


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    S.phase_environment()
    S.phase_build()
    lib2, libmat = build_first(Path(argv[0]).resolve())
    dev = torch.device("cuda", 0)
    _scene, cam, cs = S.mesh_scene(dev)
    deep = cs._replace(bvh=cs.bvh._replace(depth2=100))
    mat = cs.bvh.leaf_mat
    print(f"[plans] config 5: K4e ordered depth2 {cs.bvh.depth2} -> stack class "
          f"{bvh2.ordered_plan(cs).depth_class}, reported 100 deep -> "
          f"{bvh2.ordered_plan(deep).depth_class}; K10c depth4 {cs.bvh.depth4} -> class "
          f"{bvh_leafmat.tri_plan(cs).depth_class}; leaf table {tuple(mat.shape)} "
          f"{mat.numel() * 4 / 1e6:.2f} MB", flush=True)
    ok, timed = True, {}
    twin = {}
    n = S.N_RAYS
    any_sets = {}
    for k, (label, o, d, key, depth) in enumerate(leaf_sets(cs, cam, dev)):
        if label == "camera rays":
            so, sd, lim = S.mesh_shadow(cs, o, d, key, depth)
            any_sets["shadow rays of the camera rays"] = (cs, so, sd, lim.contiguous())
            any_sets["shadow rays of the camera rays, stack class 192"] = (
                deep, so, sd, lim.contiguous())
        elif label == "secondary rays":
            any_sets["secondary rays, per-ray limit"] = (cs, o, d, half_bound(cs, o, d, 40 + k))
        else:
            any_sets["aimed rays, limit 1e6"] = (
                cs, o, d, torch.full((n,), 1e6, dtype=torch.float32, device=dev))
        for what, bound in (("seed record (t_max 1e6)", torch.full((n,), 1e6, device=dev)),
                            ("per-ray bound", half_bound(cs, o, d, 7 + k))):
            seed = seed_record(bound)
            key_ = f"K10c, {label}, {what}"
            new = (lambda seed=seed, o=o, d=d: bvh_leafmat.tri_closest(cs, o, d, T_MIN, seed),
                   "mat_tri_closest_persistent")
            first = (lambda seed=seed, o=o, d=d: first_tri_closest(libmat, cs, o, d, seed),
                     "mat_tri_closest_kernel")
            k4c = (lambda seed=seed, o=o, d=d: bvh_paged.pages_closest(cs, o, d, T_MIN, seed),
                   "pages_closest_persistent")
            ok &= check(key_, new[0], first[0])
            timed[key_] = in_turns(key_, new, first)
            twin[key_] = in_turns(f"{key_}: against the K4c twin", new, k4c)
    def any_turns(c, o, d, lim, label):
        good = True
        for key_, (new, first, skip_new, skip_first) in any_rows(lib2, c, o, d, lim,
                                                                  label).items():
            good &= check(key_, new[0], first[0])
            good &= check(f"{key_}: the skip-link walk", skip_new[0], skip_first[0])
            timed[key_] = in_turns(key_, new, first)
        return good

    for label, (c, o, d, lim) in any_sets.items():
        ok &= any_turns(c, o, d, lim, label)
        care = lim > 0
        occ = bvh2.any_ordered(c, o, d, T_MIN, lim)
        print(f"[set] {label}: {int(care.sum())} of {n} rays need an answer, occluded "
              f"{float(occ[care].float().mean()):.4f}", flush=True)
    chain = chain_scene(bvh.STACK_CAP - 2, dev)
    for n_chain in (4096 + 37, n):  # the cuda tests' lanes, and a full launch
        co, cd = (V3(*(torch.from_numpy(a[:, i].copy()).to(dev) for i in range(3)))
                  for a in chain_rays(chain.bvh.depth2, n_chain, 31))
        ct, _ = bvh2.closest_ordered(chain, co, cd, T_MIN, 1e6)
        u = torch.rand(n_chain, generator=torch.Generator(device=dev).manual_seed(32), device=dev)
        plan = bvh2.ordered_plan(chain)
        grid = bvh.launch_grid("chain", bvh2.build().lib.ptrt_bvh2_any_occupancy, plan, n_chain,
                               dev)
        print(f"[chain] depth2 {chain.bvh.depth2} -> stack class {plan.depth_class}, {n_chain} "
              f"rays, grid {grid} blocks of {bvh.WALK_THREADS} (the first design: "
              f"{-(-n_chain // 128)} of 128)")
        bound = (ct * (0.5 + u)).contiguous()
        ok &= any_turns(chain, co, cd, bound, f"190-deep chain, {n_chain} rays")
    # the same 131,072 lanes in a shuffled order: the deep third of the rays
    # (lanes [0, n/3)) spread over all warps instead of the first ones
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(35)).to(dev)
    ok &= any_turns(chain, V3(*(x[perm].contiguous() for x in co)),
                    V3(*(x[perm].contiguous() for x in cd)), bound[perm].contiguous(),
                    f"190-deep chain, {n} rays, lanes shuffled")
    print(S.card_line())
    for name, rows in (("new / first design", timed), ("K10c / K4c twin", twin)):
        ratios = [a / b for a, b in rows.values()]
        print(f"[summary] {name}: {len(rows)} rows in turns, {min(ratios):.3f}-"
              f"{max(ratios):.3f}x (mean of rows {statistics.mean(ratios):.3f})")
    print(f"[summary] every lane bit-equal to the first designs: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
