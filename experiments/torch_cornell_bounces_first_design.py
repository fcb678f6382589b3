#!/usr/bin/env python3
"""The PyTorch + CUDA port's path bounce (K1) and Whitted bounce (K2)
against their first designs, on one NVIDIA GPU: bit for bit on every lane
and every field, and timed in turns (new, first design, first design, new)
by device time per launch.

The ray sets are those of ``bench.py``'s two figures on the Cornell box:

* K1 on the main path's first chunk (131,072 lanes of the 1024² frame,
  depth 0) and on the same lanes three plain bounces on (depths 3-5), with
  the reference shadow bound (t_max) and with ``shadow_light``;
* K2, basic and texture variants, on 131,072 camera rays spread over the
  Whitted CLI frame (2000x1500) and on that frame's first and middle
  chunks (2,099,200 camera rays each: 83,968 pixels x 25 grid cells) and
  their second bounces (the lanes that continue, compacted, as the
  renderer launches them; the first chunk has none);
* both kernels on ragged slices of 4,133 lanes and of 1 lane (bits only).

Each new kernel is timed against the first design in turns twice: with a
grid that covers its lanes once (``records``: the 16-byte records, no
balancing) and persistent (the resident blocks only, the default).

The repository keeps no copy of the first designs.  Extract their sources
from the commit that last had them into a directory and pass it:

    mkdir -p .scratch/first_bounces
    for f in path_bounce.cu whitted_bounce.cu sweep.cuh path_shade.cuh; do
      git show 80edfcd:path_tracing__ray_tracer_tpu_torch/csrc/$f > .scratch/first_bounces/$f
    done
    python3 experiments/torch_cornell_bounces_first_design.py .scratch/first_bounces

They are built with the port's ``nvcc`` flags into ``DIR/build`` under
other library names; their kernels keep their own symbols
(``path_bounce_kernel``, ``whitted_bounce_kernel``), so the profiler tells
them from the redesign's (``path_bounce_persistent``,
``whitted_bounce_persistent``).  Prints each kernel's shared-memory load
instructions by width (``cuobjdump -sass``, the whole kernel), the share of
lanes (K1) and of (light, lane) pairs (K2) whose shadow ray needs a sweep,
the card's name and power limit; exits non-zero when any lane differs.
"""
import contextlib
import ctypes
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402
import path_tracing__ray_tracer_tpu_torch as pt  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.models.whitted import grid_camera_rays  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.cuda import bounce, build, bvh, whitted  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3  # noqa: E402
from torch_page_walks_first_design import device_ms  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_first(src: Path):
    """Compile the first design's ``path_bounce.cu`` and
    ``whitted_bounce.cu``, one ``nvcc`` each, both at once, and bind them."""
    out = src / "build"
    out.mkdir(exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in ("path_bounce", "whitted_bounce"):
        lib_path = out / f"libfirst_{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src / f"{name}.cu")]
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
    k1, k2 = libs["path_bounce"].ptrt_path_bounce, libs["whitted_bounce"].ptrt_whitted_bounce
    k1.argtypes = [_P, _I, _I, _I, _I, _P, _I, _P, _I, _P] + [_P] * 9 + [_P, _P, _P, _I, _F, _F,
                                                                          _I, _P]
    k2.argtypes = ([_P, _I, _I, _I, _I, _P, _I, _P, _I] + [_P] * 6 + [_P, _P, _I, _F, _F]
                   + [_I, _I, _F, _F, _I, _I] + [_P])
    k1.restype = k2.restype = ctypes.c_int
    return k1, k2


def sass_loads(lib_path: Path) -> dict:
    """``{kernel: {load instruction: count}}``: the shared-memory loads
    (``LDS``, by width) of each kernel in a library's SASS
    (``cuobjdump -sass``), counted over the whole kernel."""
    import re

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : _ZN4ptrt(\d+)", line)
        if m:
            kernel = line[m.end():m.end() + int(m.group(1))]
            counts[kernel] = {}
        m = re.search(r"\b(LDS(?:\.[A-Z0-9]+)*)\b", line)
        if m and kernel:
            counts[kernel][m.group(1)] = counts[kernel].get(m.group(1), 0) + 1
    return counts


def print_sass(first_dir: Path):
    """The new and first designs' shared-memory loads, side by side."""
    for name, first_kernel in (("path_bounce", "path_bounce_kernel"),
                               ("whitted_bounce", "whitted_bounce_kernel")):
        new = sass_loads(build.load(name).path)
        first = sass_loads(first_dir / "build" / f"libfirst_{name}.so")
        for label, counts in (("new", new), ("first design", first)):
            for kernel, loads in counts.items():
                if kernel.startswith(name):
                    print(f"[sass] {name}, {label} {kernel}: shared loads {sum(loads.values())} "
                          f"({', '.join(f'{k} {v}' for k, v in sorted(loads.items()))})",
                          flush=True)
        assert first_kernel in first


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _tables(cs, blobs):
    layout = bounce.blob_layout(cs)
    return (blobs[0].data_ptr(), *layout[:4], blobs[1].data_ptr(),
            int(cs.materials.diffuse.shape[0]), blobs[2].data_ptr(), cs.n_lights)


def first_k1(fn, cs, blobs, state, shadow_light):
    """The first design's raw record ``(out (19, n), prim)``."""
    o, d, thr, key, depth = state
    n = o.x.shape[0]
    out = torch.empty((19, n), dtype=torch.float32, device=o.x.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    err = fn(*_tables(cs, blobs), depth.data_ptr(), *(x.data_ptr() for x in (*o, *d, *thr)),
             key.data_ptr(), out.data_ptr(), prim.data_ptr(), n, 1e-3, 1e6, int(shadow_light),
             _stream())
    bvh._raise_on("first_k1", err)
    return out, prim


def first_k2(fn, cs, blobs, o, d, v):
    n = o.x.shape[0]
    out = torch.empty((17, n), dtype=torch.float32, device=o.x.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    err = fn(*_tables(cs, blobs), *(x.data_ptr() for x in (*o, *d)), out.data_ptr(),
             prim.data_ptr(), n, 1e-3, 1e6, int(v.textured), int(v.refraction),
             float(v.falloff_scale), float(v.diffuse_gain), int(v.spec_table), int(v.base_floor),
             _stream())
    bvh._raise_on("first_k2", err)
    return out, prim


def raw(rec):
    """The wrapper's raw record ``(out, prim)``: the tensor its float
    fields are rows of."""
    out = rec.u._base
    assert out is not None and out.shape[1] == rec.prim.shape[0]
    return out, rec.prim


def new_k1(cs, blobs, state, shadow_light):
    return raw(bounce.path_bounce(cs, *blobs, *state, shadow_light=shadow_light))


def new_k2(cs, blobs, o, d, v):
    return raw(whitted.whitted_bounce(cs, *blobs, o, d, v))


def slice_state(state, n):
    o, d, thr, key, depth = state
    return (*(V3(*(c[:n].contiguous() for c in v)) for v in (o, d, thr)),
            key[:n].contiguous(), depth[:n].contiguous())


@contextlib.contextmanager
def part(name):
    """The new kernels with ``records`` (a grid that covers the lanes once)
    or ``persistent`` (the resident blocks, the default) grids."""
    saved = bvh.persistent_grid
    if name == "records":
        bvh.persistent_grid = lambda n, n_sms, blocks: max(1, -(-n // bvh.WALK_THREADS))
    try:
        yield
    finally:
        bvh.persistent_grid = saved


PARTS = ("records", "persistent")


def check(label, new, first) -> bool:
    ok = True
    want = first()
    for name in PARTS:
        with part(name):
            got = new()
        torch.cuda.synchronize()
        eq = all(S.same_bits(x, y) for x, y in zip(got, want))
        if not eq:
            bad = (got[0].view(torch.int32) != want[0].view(torch.int32)).any(0) | (
                got[1] != want[1])
            print(f"[bits]   {name}: {int(bad.sum())} lanes differ, first at lane "
                  f"{int(bad.nonzero()[0, 0])}", flush=True)
        ok &= eq
        if bvh.lane_counter(torch.device("cuda", 0)).any():
            raise SystemExit("the persistent kernels left the lane counter nonzero")
    print(f"[bits] {label}: every part bit-equal to the first design on every lane and "
          f"field: {ok}", flush=True)
    return ok


def in_turns(label, new, first):
    """Device ms per launch of each part of the new kernel and of the first
    design, each part timed in turns with the first design (part, first,
    first, part); returns the default part's ``(new, first)``."""
    (new_fn, new_sym), (first_fn, first_sym) = new, first
    rows = {}
    for name in PARTS:
        got = {"new": [], "first": []}
        how = set()
        for k in ("new", "first", "first", "new"):
            with part(name):
                ms, method = device_ms(new_fn if k == "new" else first_fn,
                                       new_sym if k == "new" else first_sym)
            got[k].append(ms)
            how.add(method)
        a, b = statistics.mean(got["new"]), statistics.mean(got["first"])
        rows[name] = (a, b)
        print(f"[turns] {label}, {name} ({'/'.join(sorted(how))}): new {a:.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in got['new'])}), first design {b:.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in got['first'])}) -> {a / b:.3f}x", flush=True)
    return rows["persistent"]


def whitted_chunks(device):
    """``{chunk: camera rays}`` of the Whitted CLI frame's first and middle
    chunks, as the renderer makes them."""
    b = pt.CustomSceneBuilder()
    cam = b.create_camera(S.W_WIDTH / S.W_HEIGHT)
    r = pt.RendererFactory.create("cuda_texture_raytracer", chunk_rays=S.W_CHUNK, seed=0,
                                  device=device)
    n_pix, group = r._plan(S.W_WIDTH, S.W_HEIGHT, S.W_SPP, S.W_DEPTH)
    n_chunks = -(-S.W_WIDTH * S.W_HEIGHT // n_pix)
    return {c: grid_camera_rays(pack_camera(cam, device), c * n_pix, n_pix, S.W_WIDTH,
                                S.W_HEIGHT, r.seed, 0, group, math.isqrt(group), S.W_DEPTH,
                                r.jitter)
            for c in (0, n_chunks // 2)}


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    S.phase_environment()
    S.phase_build()
    k1_first, k2_first = build_first(Path(argv[0]).resolve())
    print_sass(Path(argv[0]).resolve())
    dev = torch.device("cuda", 0)
    b = pt.CustomSceneBuilder()
    cs = pt.compile_scene(b.build_scene(), device=dev)
    blobs = (bounce.pack_scene_blob(cs), bounce.pack_mat_blob(cs), bounce.pack_light_blob(cs))
    ok, timed = True, {}

    start = S.camera_state(cs, b.create_camera(S.WIDTH / S.HEIGHT), S.N_RAYS, dev, stride=1)
    k1_sets = {"first chunk, depth 0": start, "first chunk, 3 plain bounces on":
               S.advance_plain(cs, start, 3)}
    S.sweep_plans("Cornell box", cs, S.N_RAYS, dev)
    for label, state in k1_sets.items():
        S.care_shares(label, cs, k1_state=state)
        for sl in (False, True):
            key = f"K1, {label}, shadow_light={sl}"
            for n in (S.N_RAYS, 4133, 1):
                st = state if n == S.N_RAYS else slice_state(state, n)
                ok &= check(f"{key}, {n} lanes", lambda st=st, sl=sl: new_k1(cs, blobs, st, sl),
                            lambda st=st, sl=sl: first_k1(k1_first, cs, blobs, st, sl))
            timed[key] = in_turns(
                key, (lambda st=state, sl=sl: new_k1(cs, blobs, st, sl), "path_bounce_persistent"),
                (lambda st=state, sl=sl: first_k1(k1_first, cs, blobs, st, sl),
                 "path_bounce_kernel"))

    camera = S.whitted_camera_rays(cs, b.create_camera(S.W_WIDTH / S.W_HEIGHT), S.N_RAYS, dev)
    chunks = whitted_chunks(dev)
    for vname, v in (("basic", whitted.BASIC), ("texture", whitted.TEXTURE)):
        sets = {f"{S.N_RAYS} camera rays": camera}
        for c, chunk in chunks.items():
            out, _prim = first_k2(k2_first, cs, blobs, *chunk, v)
            sel = torch.nonzero((out[0] > 0.5) & (out[3] > 0.5))[:, 0]
            sets[f"frame chunk {c}, {chunk[0].x.shape[0]} camera rays"] = chunk
            if sel.numel():
                sets[f"frame chunk {c}, second bounce, {sel.numel()} rays"] = (
                    V3(*(out[5 + k][sel].contiguous() for k in range(3))),
                    V3(*(out[8 + k][sel].contiguous() for k in range(3))))
        for label, (o, d) in sets.items():
            key = f"K2 {vname}, {label}"
            S.care_shares(key, cs, k2_rays=(o, d), variant=v)
            lanes = [o.x.shape[0]] + ([4133, 1] if label.startswith(str(S.N_RAYS)) else [])
            for n in lanes:
                oo, dd = (o, d) if n == o.x.shape[0] else (
                    V3(*(c[:n].contiguous() for c in o)), V3(*(c[:n].contiguous() for c in d)))
                ok &= check(f"{key}, {n} lanes", lambda oo=oo, dd=dd: new_k2(cs, blobs, oo, dd, v),
                            lambda oo=oo, dd=dd: first_k2(k2_first, cs, blobs, oo, dd, v))
            timed[key] = in_turns(
                key, (lambda o=o, d=d: new_k2(cs, blobs, o, d, v), "whitted_bounce_persistent"),
                (lambda o=o, d=d: first_k2(k2_first, cs, blobs, o, d, v), "whitted_bounce_kernel"))
    print(S.card_line())
    ratios = [a / b for a, b in timed.values()]
    print(f"[summary] {len(timed)} rows in turns: new / first design "
          f"{min(ratios):.3f}-{max(ratios):.3f}x; every lane bit-equal to the first designs: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
