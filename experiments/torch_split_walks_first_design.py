#!/usr/bin/env python3
"""The PyTorch + CUDA port's rooted multipass walk (K11) and ordered BVH2
closest walk (K4e) against their first designs, on one NVIDIA GPU: bit for
bit on every lane, and timed in turns (new, first design, first design,
new) by device time per launch.

The ray sets are ``chip_smoke.py``'s phase 19 on config 5
(``MeshSceneBuilder(3, 3)``, 11,520 triangles): 131,072 camera rays over
the 1920x1080 frame, their secondary rays one plain bounce on, and rays
from those origins aimed at random points of the mesh.  On each set: K4e's
ordered closest walk with ``t_max`` 1e6 and with a per-ray bound, also in
the deep stack class (the tree reported 100 levels deep); K11 on the three
carried passes of ``multipass_closest``.  Then K4e on the 190-deep BVH2
chain of ``tests/torch_chain.py`` (the largest class), both bounds.

The repository keeps no copy of the first designs.  Extract their sources
from the commit that last had them into a directory and pass it:

    mkdir -p .scratch/first_split
    for f in bvh_scene.cu bvh2_walk.cu bvh_walk.cuh sweep.cuh; do
      git show a3bb26a:path_tracing__ray_tracer_tpu_torch/csrc/$f > .scratch/first_split/$f
    done
    python3 experiments/torch_split_walks_first_design.py .scratch/first_split

They are built with the port's ``nvcc`` flags into ``DIR/build`` under
other library names; their kernels keep their own symbols
(``bvh4_rooted_kernel``, ``bvh2_closest_kernel``), so the profiler tells
them from the redesign's (``bvh4_rooted_persistent``,
``bvh2_closest_persistent``).  Each time is the kernel's device time per
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
from path_tracing__ray_tracer_tpu_torch.ops.cuda import build, bvh, bvh2  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3  # noqa: E402
from torch_chain import chain_rays, chain_scene  # noqa: E402
from torch_page_walks_first_design import device_ms  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_first(src: Path):
    """Compile the first design's ``bvh_scene.cu`` and ``bvh2_walk.cu``, one
    ``nvcc`` each, both at once, and bind K11 and the BVH2 closest walks."""
    out = src / "build"
    out.mkdir(exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name, source in (("scene", "bvh_scene.cu"), ("bvh2", "bvh2_walk.cu")):
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
    scene, walk2 = libs["scene"], libs["bvh2"]
    scene.ptrt_bvh4_closest_rooted.argtypes = ([_P, _I, _P] + [_P] * 10
                                               + [_I, _I, _F, _P, _P, _P])
    walk2.ptrt_bvh2_closest.argtypes = ([_P, _I, _P] + [_P] * 6
                                        + [_I, _I, _I, _F, _F, _P, _P, _P, _P])
    scene.ptrt_bvh4_closest_rooted.restype = walk2.ptrt_bvh2_closest.restype = ctypes.c_int
    return scene, walk2


def _stream():
    return torch.cuda.current_stream().cuda_stream


def first_rooted(lib, cs, o, d, roots, en, bt0, bi0):
    n = o.x.shape[0]
    bt = torch.empty((n,), dtype=torch.float32, device=o.x.device)
    bi = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    b = cs.bvh
    err = lib.ptrt_bvh4_closest_rooted(
        b.nodes4.data_ptr(), b.nodes4.shape[0] // 32, b.slot_rec.data_ptr(),
        *(x.data_ptr() for x in (*o, *d)), roots.data_ptr(), en.data_ptr(), bt0.data_ptr(),
        bi0.data_ptr(), n, bvh.gid_mask(cs), 1e-3, bt.data_ptr(), bi.data_ptr(), _stream())
    bvh._raise_on("first_rooted", err)
    return bt, bi


def first_ordered(lib, cs, o, d, bound):
    n = o.x.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.x.device)
    tri = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    b = cs.bvh
    per_ray = isinstance(bound, torch.Tensor)
    err = lib.ptrt_bvh2_closest(
        b.tree2.data_ptr(), b.tree2.shape[0] // 8, b.slot_rec.data_ptr(),
        *(x.data_ptr() for x in (*o, *d)), n, 1, bvh.gid_mask(cs), 1e-3,
        0.0 if per_ray else float(bound), bound.data_ptr() if per_ray else None, t.data_ptr(),
        tri.data_ptr(), _stream())
    bvh._raise_on("first_ordered", err)
    return t, tri


def bit_equal(a, b) -> bool:
    return all(S.same_bits(x, y) for x, y in zip(a, b))


def check(label, new, first) -> bool:
    eq = bit_equal(new(), first())
    torch.cuda.synchronize()
    print(f"[bits] {label}: bit-equal to the first design on every lane: {eq}", flush=True)
    if bvh.lane_counter(torch.device("cuda", 0)).any():
        raise SystemExit("the persistent walks left the lane counter nonzero")
    return eq


def in_turns(label, new, first):
    """Device ms per launch of ``new`` and ``first`` (each ``(call,
    symbol)``), timed new, first, first, new."""
    got = {"new": [], "first design": []}
    how = set()
    for k, (fn, symbol) in (("new", new), ("first design", first), ("first design", first),
                            ("new", new)):
        ms, method = device_ms(fn, symbol)
        got[k].append(ms)
        how.add(method)
    new_ms, first_ms = (statistics.mean(v) for v in got.values())
    print(f"[turns] {label} ({'/'.join(sorted(how))}): new {new_ms:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in got['new'])}), first design {first_ms:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in got['first design'])}) -> "
          f"{new_ms / first_ms:.3f}x", flush=True)
    return new_ms, first_ms


def ordered_rows(lib2, cs, o, d, bound, label):
    """K4e ordered closest, new and first, with t_max 1e6 and ``bound``."""
    rows = {}
    for what, b in (("t_max 1e6", 1e6), ("per-ray bound", bound)):
        rows[f"K4e ordered closest, {label}, {what}"] = (
            (lambda b=b: bvh2.closest_ordered(cs, o, d, 1e-3, b), "bvh2_closest_persistent"),
            (lambda b=b: first_ordered(lib2, cs, o, d, b), "bvh2_closest_kernel"))
    return rows


def split_sets(cs, cam, dev):
    """phase 19's three ray sets as ``(label, o, d)``."""
    camera = S.camera_state(cs, cam, S.N_RAYS, dev, S.M_WIDTH, S.M_HEIGHT, S.M_DEPTH)
    bo, bd, _t, bkey, _depth = S.advance_plain(cs, camera, 1)
    ao, ad, _key, _adepth = S.aimed_rays(cs, bo, bkey)
    return (("camera rays", camera[0], camera[1]), ("secondary rays", bo, bd),
            ("aimed rays", ao, ad))


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    S.phase_environment()
    S.phase_build()
    lib_scene, lib2 = build_first(Path(argv[0]).resolve())
    dev = torch.device("cuda", 0)
    _scene, cam, cs = S.mesh_scene(dev)
    deep = cs._replace(bvh=cs.bvh._replace(depth2=100))
    print(f"[plans] config 5: K11 depth4 {cs.bvh.depth4} -> class "
          f"{bvh.rooted_plan(cs).depth_class}; K4e depth2 {cs.bvh.depth2} -> stack class "
          f"{bvh2.ordered_plan(cs).depth_class}, reported 100 deep -> "
          f"{bvh2.ordered_plan(deep).depth_class}", flush=True)
    ok, timed = True, {}
    n = S.N_RAYS
    for label, o, d in split_sets(cs, cam, dev):
        want_t, _ = tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, 1e-3, 1e6)
        u = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        bound = (want_t * (0.5 + u)).contiguous()  # about half of the hits lie beyond it
        rows = ordered_rows(lib2, cs, o, d, bound, label)
        for key, (new, first) in ordered_rows(lib2, deep, o, d, bound, label).items():
            ok &= check(f"{key}, stack class {bvh2.ordered_plan(deep).depth_class}", new[0],
                        first[0])
        bt = torch.full((n,), 1e6, dtype=torch.float32, device=dev)
        bi = torch.full((n,), -1, dtype=torch.int32, device=dev)
        for k, (roots, en) in enumerate(S.split_passes(cs, o, d)):
            c = (roots, en, bt, bi)
            rows[f"K11 pass {k + 1} ({int(en.sum())} lanes walk), {label}"] = (
                (lambda c=c: bvh.closest_rooted(cs, o, d, 1e-3, *c), "bvh4_rooted_persistent"),
                (lambda c=c: first_rooted(lib_scene, cs, o, d, *c), "bvh4_rooted_kernel"))
            bt, bi = bvh.closest_rooted(cs, o, d, 1e-3, *c)
        for key, (new, first) in rows.items():
            ok &= check(key, new[0], first[0])
        for key, (new, first) in rows.items():
            timed[key] = in_turns(key, new, first)
    chain = chain_scene(bvh.STACK_CAP - 2, dev)
    co, cd = (V3(*(torch.from_numpy(a[:, i].copy()).to(dev) for i in range(3)))
              for a in chain_rays(chain.bvh.depth2, 4096 + 37, 31))
    ct, _ = bvh2.closest_ordered(chain, co, cd, 1e-3, 1e6)
    u = torch.rand(co.x.shape[0], generator=torch.Generator(device=dev).manual_seed(32),
                   device=dev)
    print(f"[chain] depth2 {chain.bvh.depth2} -> stack class "
          f"{bvh2.ordered_plan(chain).depth_class}, {co.x.shape[0]} rays")
    for key, (new, first) in ordered_rows(lib2, chain, co, cd, (ct * (0.5 + u)).contiguous(),
                                          "190-deep chain").items():
        ok &= check(key, new[0], first[0])
        timed[key] = in_turns(key, new, first)
    print(S.card_line())
    ratios = [a / b for a, b in timed.values()]
    print(f"[summary] {len(timed)} rows in turns: new / first design "
          f"{min(ratios):.3f}-{max(ratios):.3f}x; every lane bit-equal to the first designs: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
