#!/usr/bin/env python3
"""The PyTorch + CUDA port's fused pipe step (K7) and skip-link BVH2
closest walk (K4e) against their first designs, on one NVIDIA GPU: bit for
bit on every lane and every output row, and timed in turns (new, first
design, first design, new) by device time per launch.

The sets:

* K7 on the Cornell box at N = 131,072 and at a ragged N = 131,077, each
  on ``chip_smoke.py``'s check chunk (the first N lanes of the 1024² frame,
  ``MODE_SPP`` samples, depth 8, after ``MODE_STEPS`` plain fused steps:
  retired, regenerated and live lanes), also with ``shadow_tmax="light"``;
  on the first step (the priming record: every lane on its first camera
  ray); and on a late step, most lanes retired;
* the skip-link closest walk on config 5 (``MeshSceneBuilder(3, 3)``) at
  131,072 and 131,077 rays of ``chip_smoke.py`` phase 19's three sets
  (camera rays, their secondary rays one plain bounce on, rays aimed at
  the mesh), each with ``t_max`` 1e6 and with a per-ray bound; then on the
  190-deep BVH2 chain of ``tests/torch_chain.py`` at 131,072 and 4,133
  rays, both bounds.

The repository keeps no copy of the first designs.  Extract their sources
from the commit that last had them into a directory and pass it:

    mkdir -p .scratch/first_k7_k4e
    for f in path_step.cu bvh2_walk.cu sweep.cuh path_shade.cuh bvh_walk.cuh; do
      git show 5d3f023:path_tracing__ray_tracer_tpu_torch/csrc/$f > .scratch/first_k7_k4e/$f
    done
    python3 experiments/torch_pipe_step_and_skiplink_first_design.py .scratch/first_k7_k4e

The skip-link walk is also timed in turns at more resident blocks: the
current ``bvh2_walk.cu`` built with ``__launch_bounds__(kWalkThreads, B)``
for B in ``VARIANT_BLOCKS`` on its kernel (fewer registers a thread, more
warps an SM), bit-equal all the same.

They are built with the port's ``nvcc`` flags into ``DIR/build`` under
other library names; their kernels keep their own symbols
(``path_step_kernel``, ``bvh2_closest_kernel``), so the profiler tells them
from the redesign's (``path_step_persistent``,
``bvh2_closest_skiplink_persistent``).  Each time is the kernel's device
time per launch (``torch_page_walks_first_design.device_ms``).  Prints each
library's registers, stack and spill (``ptxas -v``), the new kernels'
resident blocks an SM, the card's name and power limit; exits non-zero
when any lane differs.
"""
import contextlib
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "tests"))

import chip_smoke as S  # noqa: E402
import path_tracing__ray_tracer_tpu_torch as pt  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.models import experimental  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, build, bvh, bvh2, step  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3  # noqa: E402
from torch_chain import chain_rays, chain_scene  # noqa: E402
from torch_page_walks_first_design import device_ms  # noqa: E402
from torch_split_walks_first_design import split_sets  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
RAGGED = S.N_RAYS + 5
VARIANT_BLOCKS = (4, 5)
_BOUNDS = "__launch_bounds__(kWalkThreads)\nbvh2_closest_skiplink_persistent("


def build_first(src: Path):
    """Compile the first design's ``path_step.cu`` and ``bvh2_walk.cu``, one
    ``nvcc`` each, both at once, and bind K7 and the BVH2 closest walks."""
    out = src / "build"
    out.mkdir(exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name, source in (("path_step", "path_step.cu"), ("bvh2", "bvh2_walk.cu")):
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
    k7, walk2 = libs["path_step"].ptrt_path_step, libs["bvh2"].ptrt_bvh2_closest
    k7.argtypes = [_P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _I, _P, step._StepIn,
                   step._StepConsts, _P, _P, _I, _F, _F, _I, _P]
    walk2.argtypes = ([_P, _I, _P, _P] + [_P] * 6 + [_I, _I, _I, _F, _F, _P, _P, _P]
                      + [_P, _I, _I, _P])
    k7.restype = walk2.restype = ctypes.c_int
    return k7, walk2


def build_variants(out: Path) -> dict:
    """``{blocks: bound library}``: the current BVH2 walks with the
    skip-link walk's launch bounds asking for ``blocks`` resident blocks."""
    src = (build.CSRC / "bvh2_walk.cu").read_text()
    assert _BOUNDS in src
    jobs = {}
    for blocks in VARIANT_BLOCKS:
        path = out / f"bvh2_walk_{blocks}.cu"
        path.write_text(src.replace(_BOUNDS, _BOUNDS.replace(")", f", {blocks})", 1)))
        lib_path = out / f"libvariant_bvh2_{blocks}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib_path),
               str(path)]
        jobs[blocks] = (lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {}
    for blocks, (lib_path, proc) in jobs.items():
        log = proc.communicate()[0]
        print(f"[variant] {blocks} blocks: " + "; ".join(
            x for x in S.ptxas_summary(log).split("; ") if "skiplink" in x or "rror" in x),
              flush=True)
        if proc.returncode:
            raise SystemExit(log)
        lib = ctypes.CDLL(str(lib_path))
        real = bvh2.build().lib
        for name in ("ptrt_bvh2_closest", "ptrt_bvh2_skiplink_occupancy", "ptrt_bvh2_stack_cap"):
            fn, bound = getattr(lib, name), getattr(real, name)
            fn.argtypes, fn.restype = bound.argtypes, bound.restype
        libs[blocks] = lib
    return libs


@contextlib.contextmanager
def variant(lib):
    """``bvh2.closest_skiplink`` launching ``lib``'s walk, its grid asked
    of its own occupancy entry."""
    saved, resident = bvh2.build, dict(bvh._RESIDENT)
    bvh2.build = lambda: SimpleNamespace(lib=lib)
    bvh._RESIDENT.clear()
    try:
        yield
    finally:
        bvh2.build = saved
        bvh._RESIDENT.clear()
        bvh._RESIDENT.update(resident)


def variant_turns(label, libs, call):
    """Device ms per launch of the kept walk and each variant, timed in a
    palindrome order; each variant's bits against the kept walk's."""
    order = (None, *libs, *reversed(tuple(libs)), None)
    got = {k: [] for k in (None, *libs)}
    ok = True
    want = call()
    for k in order:
        with variant(libs[k]) if k else contextlib.nullcontext():
            if k and len(got[k]) == 0:
                ok &= bit_equal(call(), want)
            got[k].append(device_ms(call, "bvh2_closest_skiplink_persistent")[0])
    kept = statistics.mean(got[None])
    print(f"[variant] {label}: kept (256 threads, no minimum) {kept:.4f} ms; " + "; ".join(
        f"{k} blocks {statistics.mean(v):.4f} ms ({statistics.mean(v) / kept:.3f}x)"
        for k, v in got.items() if k) + f"; bit-equal {ok}", flush=True)
    return ok


def print_builds():
    """The new libraries' registers, stack and spill (built in this process
    by ``chip_smoke.phase_build``), and the new kernels' resident blocks."""
    for name in ("path_step", "bvh2"):
        print(f"[build] new {name}: {S.ptxas_summary(build.load(name).log)}", flush=True)


def resident(cs_cornell, dev):
    blocks = ctypes.c_int(0)
    plan = step.step_plan(cs_cornell, bvh.smem_limit(dev))
    bvh._raise_on("k7", step.build().lib.ptrt_path_step_occupancy(plan.smem_bytes,
                                                                   ctypes.byref(blocks)))
    k7 = blocks.value
    bvh._raise_on("skiplink", bvh2.build().lib.ptrt_bvh2_skiplink_occupancy(
        *bvh2.SKIPLINK_PLAN, ctypes.byref(blocks)))
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[occupancy] path_step_persistent: {k7} resident blocks of {bvh.WALK_THREADS} an SM "
          f"({plan.smem_bytes} B of shared memory a block; grid at {S.N_RAYS} lanes "
          f"{bvh.persistent_grid(S.N_RAYS, n_sms, k7)}, the first design "
          f"{-(-S.N_RAYS // 256)} blocks of 256); bvh2_closest_skiplink_persistent: "
          f"{blocks.value} an SM (grid {bvh.persistent_grid(S.N_RAYS, n_sms, blocks.value)}, the "
          f"first design {-(-S.N_RAYS // 128)} blocks of 128)", flush=True)


@contextlib.contextmanager
def first_k7(fn):
    """``step.path_step`` launching the first design's K7 (its C entry has
    no lane counter, shared bytes or grid), the outputs packed as the
    wrapper packs the new kernel's."""
    saved = step.build
    real = saved().lib
    lib = SimpleNamespace(ptrt_path_step=lambda *a: fn(*a[:-4], a[-1]),
                          ptrt_path_step_occupancy=real.ptrt_path_step_occupancy)
    step.build = lambda: SimpleNamespace(lib=lib)
    try:
        yield
    finally:
        step.build = saved


def leaves(out):
    for x in out:
        yield from (leaves(x) if isinstance(x, tuple) else (x,))


def bit_equal(got, want) -> bool:
    return all(S.same_bits(a, b) for a, b in zip(leaves(got), leaves(want)))


def check(label, new, first) -> bool:
    with first():
        want = new()
    got = new()
    torch.cuda.synchronize()
    eq = bit_equal(got, want)
    for k, (a, b) in enumerate(zip(leaves(got), leaves(want))):
        if not S.same_bits(a, b):
            bad = a.view(torch.int32) != b.view(torch.int32) if a.is_floating_point() else a != b
            print(f"[bits]   output {k}: {int(bad.sum())} lanes differ", flush=True)
    print(f"[bits] {label}: every output bit-equal to the first design on every lane: {eq}",
          flush=True)
    if bvh.lane_counter(torch.device("cuda", 0)).any():
        raise SystemExit("the persistent kernels left the lane counter nonzero")
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


def k7_sets(cs, blobs, cam12, k7_first, n):
    """``{label: path_step arguments}`` of the K7 sets at ``n`` lanes."""
    sets = {}
    for tmax in ("reference", "light"):
        start = experimental.pipe_start(
            cs, blobs, cam12, 0, 0, 0, n_pix=n, width=S.WIDTH, height=S.HEIGHT,
            n_samples=S.MODE_SPP, max_depth=S.DEPTH, jitter="independent", shadow_tmax=tmax)
        st, tables, scal, lane = start
        if tmax == "reference":
            sets["first step"] = start
        for _ in range(S.MODE_STEPS):
            out = step.path_step_plain(cs, st, tables, cam12, scal, lane[0],
                                       experimental.step_texel(cs, st, lane[0]), *lane[1:])
            lane = (out[0],) + out[3:11]
        sets[f"check chunk, shadow_tmax={tmax}"] = (st, tables, scal, lane)
    st, tables, scal, lane = sets["first step"]
    steps = 0
    with first_k7(k7_first):  # advanced by the first design
        while float((lane[5] == st.ns).float().mean()) < 0.75 and steps <= st.ns * st.max_depth:
            out = step.path_step(cs, st, tables, cam12, scal, lane[0],
                                 experimental.step_texel(cs, st, lane[0]), *lane[1:])
            lane, steps = (out[0],) + out[3:11], steps + 1
    sets[f"late step ({steps} steps on, "
         f"{float((lane[5] == st.ns).float().mean()):.3f} of lanes retired)"] = (
        st, tables, scal, lane)
    args = {}
    for label, (st, tables, scal, lane) in sets.items():
        args[label] = (cs, st, tables, cam12, scal, lane[0],
                       experimental.step_texel(cs, st, lane[0]), *lane[1:])
        s0 = lane[5]
        print(f"[k7] {n} lanes, {label}: retired {int((s0 == st.ns).sum())}, live "
              f"{int((s0 < st.ns).sum())}", flush=True)
    return args


def first_skiplink(lib, cs, o, d, bound):
    n = o.x.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.x.device)
    tri = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    b = cs.bvh
    per_ray = isinstance(bound, torch.Tensor)
    err = lib(b.tree2.data_ptr(), b.tree2.shape[0] // 8, b.slot_rec.data_ptr(), None,
              *(x.data_ptr() for x in (*o, *d)), n, 0, bvh.gid_mask(cs), 1e-3,
              0.0 if per_ray else float(bound), bound.data_ptr() if per_ray else None,
              t.data_ptr(), tri.data_ptr(), None, 0, 0, torch.cuda.current_stream().cuda_stream)
    bvh._raise_on("first_skiplink", err)
    return t, tri


def ragged(v, n):
    """The first ``n`` of ``v``'s lanes, its first lanes repeated past its end."""
    return V3(*(torch.cat([c, c[:n - c.shape[0]]]).contiguous() if n > c.shape[0]
                else c[:n].contiguous() for c in v))


def skiplink_rows(lib2, cs, o, d, label, seed):
    """``{label: ((new call, symbol), (first call, symbol))}``: t_max 1e6 and
    a per-ray bound (about half of the hits beyond it)."""
    want_t, _ = tbvh.traverse_closest(cs.bvh, cs.triangles, o, d, 1e-3, 1e6)
    u = torch.rand(o.x.shape[0], generator=torch.Generator(device=o.x.device).manual_seed(seed),
                   device=o.x.device)
    bound = (want_t * (0.5 + u)).contiguous()
    rows = {}
    for what, b in (("t_max 1e6", 1e6), ("per-ray bound", bound)):
        rows[f"K4e skip-link closest, {label}, {what}"] = (
            (lambda b=b: bvh2.closest_skiplink(cs, o, d, 1e-3, b),
             "bvh2_closest_skiplink_persistent"),
            (lambda b=b: first_skiplink(lib2, cs, o, d, b), "bvh2_closest_kernel"))
    return rows


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    S.phase_environment()
    S.phase_build()
    print_builds()
    k7_first, lib2 = build_first(Path(argv[0]).resolve())
    variants = build_variants(Path(argv[0]).resolve() / "build")
    dev = torch.device("cuda", 0)
    b = pt.CustomSceneBuilder()
    cs = pt.compile_scene(b.build_scene(), device=dev)
    blobs = (bounce.pack_scene_blob(cs), bounce.pack_mat_blob(cs), bounce.pack_light_blob(cs))
    cam12 = pt.pack_camera(b.create_camera(S.WIDTH / S.HEIGHT), dev)
    resident(cs, dev)
    ok, timed = True, {}

    for n in (S.N_RAYS, RAGGED):
        for label, args in k7_sets(cs, blobs, cam12, k7_first, n).items():
            key = f"K7, {n} lanes, {label}"
            ok &= check(key, lambda args=args: step.path_step(*args),
                        lambda: first_k7(k7_first))
            if n == S.N_RAYS:
                timed[key] = in_turns(
                    key, (lambda args=args: step.path_step(*args), "path_step_persistent"),
                    (lambda args=args: _first_call(k7_first, args), "path_step_kernel"))

    _scene, cam, mcs = S.mesh_scene(dev)
    for label, o, d in split_sets(mcs, cam, dev):
        for n in (S.N_RAYS, RAGGED):
            oo, dd = ragged(o, n), ragged(d, n)
            for key, (new, first) in skiplink_rows(lib2, mcs, oo, dd, f"{label}, {n} rays",
                                                   5).items():
                ok &= _check_walk(key, new[0], first[0])
                if n == S.N_RAYS:
                    timed[key] = in_turns(key, new, first)
                    ok &= variant_turns(key, variants, new[0])
    chain = chain_scene(bvh.STACK_CAP - 2, dev)
    for n in (S.N_RAYS, 4096 + 37):
        co, cd = (V3(*(torch.from_numpy(a[:, i].copy()).to(dev) for i in range(3)))
                  for a in chain_rays(chain.bvh.depth2, n, 31))
        for key, (new, first) in skiplink_rows(lib2, chain, co, cd,
                                               f"190-deep chain, {n} rays", 32).items():
            ok &= _check_walk(key, new[0], first[0])
            timed[key] = in_turns(key, new, first)
            ok &= variant_turns(key, variants, new[0])
    print(S.card_line())
    ratios = {k: a / b for k, (a, b) in timed.items()}
    for prefix in ("K7", "K4e"):
        r = [v for k, v in ratios.items() if k.startswith(prefix)]
        print(f"[summary] {prefix}: {len(r)} rows in turns, new / first design "
              f"{min(r):.3f}-{max(r):.3f}x")
    print(f"[summary] every lane bit-equal to the first designs: {ok}")
    return 0 if ok else 1


def _first_call(k7_first, args):
    with first_k7(k7_first):
        return step.path_step(*args)


def _check_walk(label, new, first) -> bool:
    eq = bit_equal(new(), first())
    torch.cuda.synchronize()
    print(f"[bits] {label}: t and triangle bit-equal to the first design on every lane: {eq}",
          flush=True)
    if bvh.lane_counter(torch.device("cuda", 0)).any():
        raise SystemExit("the persistent walk left the lane counter nonzero")
    return eq


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
