#!/usr/bin/env python3
"""The PyTorch + CUDA port's brute-force sweeps, K3a (closest hit,
``intersect.closest_hit``) and K3b (any hit under a per-ray bound,
``intersect.any_hit``), against their first designs, on one NVIDIA GPU:
every output bit for bit on every lane, timed in turns (new, first design,
first design, new) by device time per launch.

The sets:

* ``chip_smoke.py``'s 131,072 rays on the Cornell box (the Whitted
  conventions): the Whitted frame's camera rays (K3a, t_max 1e6) and one
  light-sample shadow ray per lane bounded at its light (K3b);
* random rays over the box at 131,077 and 262,149 lanes (past the resident
  blocks), their slices of 4,133 and 1 lanes, K3a with t_max 1e6, 1e30,
  ``+inf`` and ``t_min`` itself (every lane misses), K3b with per-ray
  bounds of which a quarter are at or below ``t_min`` (-1, 0, ``t_min``,
  ``t_min / 2``), a quarter ``+inf`` and the rest in (0, 60);
* every launch of the oracle frame's first chunk (``cpu_raytracer``,
  320x240, 4 spp, depth 6, host conventions), as the renderer makes it:
  level 0's 262,144 camera rays (t_max 1e30) and its shadow batch of
  4,194,304 rays (16 light samples x 262,144 lanes, each bounded at its
  light), then every deeper level;
* every launch of the first chunk of the CLI default frame through the
  oracle (2000x1500, 25 spp, depth 16 clamped to 12): 25,600 lanes at
  level 0 and its 409,600 shadow rays, then every deeper level.

Timed in turns: the 131,072 sets, the oracle frame's level 0 (262,144 and
4,194,304) and the CLI chunk's level 0 (25,600 and 409,600).  On the same
sets, beside the kept builds, two variants, each bit-checked and timed in a
palindrome (kept, variant, variant, kept): the kept kernels on a grid that
covers every lane once (``records``: no lane counter, a copy of the records
per 256 lanes), and the current sources asking for the first designs'
resident blocks an SM (``MIN_BLOCKS``: K3a 6, K3b 8; launched through their
own C entries and occupancy entries, as the wrapper launches the kept ones).

The repository keeps no copy of the first designs.  Extract their sources
from the commit that last had them into a directory and pass it:

    mkdir -p .scratch/first_intersect
    for f in intersect.cu sweep.cuh; do
      git show 5f6caf2:path_tracing__ray_tracer_tpu_torch/csrc/$f > .scratch/first_intersect/$f
    done
    python3 experiments/torch_intersect_first_design.py .scratch/first_intersect

The first design is built with the port's ``nvcc`` flags into ``DIR/build``
with an occupancy entry appended (``first_isect_occupancy``); its kernels
keep their symbols (``closest_kernel``, ``any_kernel``), so the profiler
tells them from the redesign's (``closest_hit_persistent``,
``any_hit_persistent``).  Prints both builds' registers, stack and spill
(``ptxas -v``), each design's resident blocks an SM, grid and waves at each
timed shape, the card's name and power limit; exits non-zero when any lane
differs or the lane counter is left nonzero.
"""
import contextlib
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
import path_tracing__ray_tracer_tpu_torch as pt  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.compiler import pack_camera  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.models import whitted_oracle as wo  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.cuda import build, bvh, intersect  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.cuda.bounce import (  # noqa: E402
    blob_layout, pack_scene_blob, sweep_plan)
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3  # noqa: E402
from torch_page_walks_first_design import device_ms  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
T_MIN = 1e-3
THREADS = 256
NEW = {"closest": "closest_hit_persistent", "any": "any_hit_persistent"}
FIRST = {"closest": "closest_kernel", "any": "any_kernel"}
MIN_BLOCKS = {"closest": 6, "any": 8}
_FIRST_OCC = """
extern "C" int first_isect_occupancy(int any, int smem, int* blocks) {
  return any ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ptrt::any_kernel, 256,
                                                                  smem)
             : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ptrt::closest_kernel,
                                                                  256, smem);
}
"""


def build_first(src: Path):
    """Compile the first design's ``intersect.cu`` (with its ``sweep.cuh``)
    and bind its entries; prints both designs' ptxas summaries."""
    out = src / "build"
    out.mkdir(exist_ok=True)
    path = out / "intersect.cu"
    path.write_text((src / "intersect.cu").read_text() + _FIRST_OCC)
    (out / "sweep.cuh").write_text((src / "sweep.cuh").read_text())
    lib_path = out / "libfirst_intersect.so"
    t0 = time.perf_counter()
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    print(f"[ptxas] first design ({time.perf_counter() - t0:.2f} s): "
          f"{S.ptxas_summary(proc.stdout + proc.stderr)}", flush=True)
    print(f"[ptxas] new: {S.ptxas_summary(build.load('intersect').log)}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.ptrt_closest_hit.argtypes = [_P, _I, _I, _I, _I] + [_P] * 6 + [_I, _F, _F] + [_P] * 8
    lib.ptrt_any_hit.argtypes = [_P, _I, _I, _I, _I] + [_P] * 7 + [_I, _F, _P, _P]
    lib.first_isect_occupancy.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.ptrt_closest_hit, lib.ptrt_any_hit, lib.first_isect_occupancy):
        fn.restype = ctypes.c_int
    return lib


def build_blocks():
    """The current ``intersect.cu`` with each kernel asking for
    ``MIN_BLOCKS`` resident blocks, one library a kernel, built at once;
    ``{kind: CDLL}`` with the kept entries' argument types."""
    kept = intersect.build().lib
    text = (build.CSRC / "intersect.cu").read_text()
    out = build.BUILD_DIR / "k3_blocks"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kind, blocks in MIN_BLOCKS.items():
        head = f"__launch_bounds__(kIsectThreads)\n{NEW[kind]}("
        if text.count(head) != 1:
            raise SystemExit(f"intersect.cu: {NEW[kind]}'s launch bounds are not where expected")
        src = out / f"intersect_{kind}.cu"
        src.write_text(text.replace(head, head.replace(")", f", {blocks})", 1)))
        lib_path = out / f"libk3_{kind}_{blocks}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib_path),
               str(src)]
        jobs[kind] = (lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    libs = {}
    for kind, (lib_path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(log)
        rows = [x for x in S.ptxas_summary(log).split("; ") if x.startswith(NEW[kind])]
        print(f"[ptxas] {NEW[kind]} asking for {MIN_BLOCKS[kind]} blocks: {'; '.join(rows)}",
              flush=True)
        lib = ctypes.CDLL(str(lib_path))
        for name in ("ptrt_closest_hit", "ptrt_any_hit", "ptrt_closest_hit_occupancy",
                     "ptrt_any_hit_occupancy"):
            fn, bound = getattr(lib, name), getattr(kept, name)
            fn.argtypes, fn.restype = bound.argtypes, bound.restype
        libs[kind] = lib
    return libs


@contextlib.contextmanager
def variant(lib):
    """The wrappers launching ``lib``'s entries (a variant build) in place
    of the package's."""
    built = intersect.build()
    saved = intersect.build, bvh._RESIDENT
    intersect.build = lambda: built._replace(lib=lib)
    bvh._RESIDENT = {}  # the variant's own occupancy entry sizes its grid
    try:
        yield
    finally:
        for key, blocks in bvh._RESIDENT.items():
            print(f"[waves] variant {key[0]}: {blocks} resident blocks an SM", flush=True)
        intersect.build, bvh._RESIDENT = saved


@contextlib.contextmanager
def records_grid():
    """A grid that covers every lane once: no lane counter."""
    saved = bvh.persistent_grid
    bvh.persistent_grid = lambda n, n_sms, blocks: max(1, -(-n // THREADS))
    try:
        yield
    finally:
        bvh.persistent_grid = saved


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _counts(cs):
    return blob_layout(cs)[:4]


def first_closest(lib, cs, blob, o, d, t_min, t_max):
    """The first design's ``(6, n)`` floats (t, nx, ny, nz, u, v) and prim."""
    n = o.x.shape[0]
    out = torch.empty((6, n), dtype=torch.float32, device=o.x.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    err = lib.ptrt_closest_hit(
        blob.data_ptr(), *_counts(cs), *(x.data_ptr() for x in (*o, *d)), n, float(t_min),
        float(t_max), out[0].data_ptr(), prim.data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), out[4].data_ptr(), out[5].data_ptr(), _stream())
    bvh._raise_on("first closest_hit", err)
    return out, prim


def first_any(lib, cs, blob, o, d, t_min, t_max):
    n = o.x.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.x.device)
    err = lib.ptrt_any_hit(blob.data_ptr(), *_counts(cs), *(x.data_ptr() for x in (*o, *d)),
                           t_max.data_ptr(), n, float(t_min), occ.data_ptr(), _stream())
    bvh._raise_on("first any_hit", err)
    return occ


def new_closest(cs, blob, o, d, t_min, t_max):
    rec = intersect.closest_hit(cs, blob, o, d, t_min, t_max)
    return torch.stack([rec.t, *rec.normal, rec.u, rec.v]), rec.prim


def new_any(cs, blob, o, d, t_min, t_max):
    return intersect.any_hit(cs, blob, o, d, t_min, t_max)


def check(label, new, first) -> bool:
    got, want = new(), first()
    torch.cuda.synchronize()
    if bvh.lane_counter(torch.device("cuda", 0)).any():
        raise SystemExit(f"{label}: the lane counter was left nonzero")
    if isinstance(got, tuple):
        bad = (got[0].view(torch.int32) != want[0].view(torch.int32)).any(0) | (got[1] != want[1])
        extra = f", {int((got[1] >= 0).sum())} hit"
    else:
        bad = got != want
        extra = f", {int(got.sum())} occluded"
    ok = not bool(bad.any())
    print(f"[bits] {label}: {bad.shape[0]} lanes{extra}; bit-equal on every lane: {ok}"
          + ("" if ok else f" ({int(bad.sum())} differ, first at {int(bad.nonzero()[0, 0])})"),
          flush=True)
    return ok


def random_rays(n, seed, dev):
    """Rays from the camera and from inside the box, with per-ray bounds:
    a quarter at or below ``T_MIN``, a quarter ``+inf``, the rest in (0, 60)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    o = torch.empty((n, 3)).uniform_(-14, 14, generator=g)
    o[: n // 2] = torch.tensor([0.0, 0.0, 50.0])
    d = torch.randn((n, 3), generator=g)
    bound = torch.rand(n, generator=g) * 60
    pick = torch.randint(0, 8, (n,), generator=g)
    low = torch.tensor([-1.0, 0.0, T_MIN, T_MIN / 2])
    bound = torch.where(pick < 2, low[torch.randint(0, 4, (n,), generator=g)], bound)
    bound = torch.where((pick >= 2) & (pick < 4), torch.full_like(bound, float("inf")), bound)
    to = lambda x: x.to(dev).contiguous()  # noqa: E731
    return (V3(*(to(o[:, k]) for k in range(3))), V3(*(to(d[:, k]) for k in range(3))),
            to(bound))


def frame_launches(device, width, height, spp, depth, chunk_rays=None):
    """``(cs, blob, [(kind, args)])``: every K3a and K3b launch of the first
    chunk of the oracle frame (``_chunk`` of chunk 0), its inputs kept."""
    b = pt.CustomSceneBuilder()
    scene, cam = b.build_scene(), b.create_camera(width / height)
    kw = {} if chunk_rays is None else {"chunk_rays": chunk_rays}
    r = pt.RendererFactory.create("cpu_raytracer", seed=0, device=device, **kw)
    cs = r.compiled(scene)
    blob = r.blobs(cs)[0]
    n_pix, group = r._plan(width, height, spp, depth)
    launches = []
    real = wo.closest_hit, wo.any_hit

    def closest(cs_, blob_, o, d, t_min, t_max):
        launches.append(("closest", (o, d, t_min, t_max)))
        return real[0](cs_, blob_, o, d, t_min, t_max)

    def any_(cs_, blob_, o, d, t_min, t_max):
        launches.append(("any", (o, d, t_min, t_max)))
        return real[1](cs_, blob_, o, d, t_min, t_max)

    wo.closest_hit, wo.any_hit = closest, any_
    try:
        sums = torch.zeros((3, n_pix), dtype=torch.float32, device=device)
        r._chunk(cs, pack_camera(cam, device), sums, 0, r.seed, 0, n_pix=n_pix, width=width,
                 height=height, n_samples=group, max_depth=depth)
    finally:
        wo.closest_hit, wo.any_hit = real
    torch.cuda.synchronize()
    return cs, blob, launches


def waves(lib, kind, cs, n, dev):
    """Resident blocks an SM, grid and lane passes of both designs at ``n``."""
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = sweep_plan("waves", _counts(cs), 0, 0, bvh.smem_limit(dev))
    key = ("closest_hit" if kind == "closest" else "any_hit", dev.index, plan)
    new_blocks = bvh._RESIDENT[key]
    grid = bvh.persistent_grid(n, n_sms, new_blocks)
    blocks = ctypes.c_int(0)
    bvh._raise_on("first occupancy", lib.first_isect_occupancy(
        int(kind == "any"), 4 * blob_layout(cs).size, ctypes.byref(blocks)))
    first_grid = -(-n // THREADS)
    return (f"new {new_blocks} blocks of {THREADS} an SM, grid {grid}, "
            f"{n / (grid * THREADS):.2f} lane passes; first design {blocks.value} blocks an SM "
            f"grid {first_grid}, "
            f"{first_grid / (blocks.value * n_sms):.2f} waves")


def in_turns(label, new, first, symbols, names=("new", "first design")):
    """Device ms a launch of ``new`` and ``first`` (callables run inside a
    context each, or plain), timed new, first, first, new."""
    got = {"new": [], "first": []}
    how = set()
    for k in ("new", "first", "first", "new"):
        fn = new if k == "new" else first
        with (fn[1]() if isinstance(fn, tuple) else contextlib.nullcontext()):
            ms, method = device_ms(fn[0] if isinstance(fn, tuple) else fn, symbols[k])
        got[k].append(ms)
        how.add(method)
    a, b = statistics.mean(got["new"]), statistics.mean(got["first"])
    print(f"[turns] {label} ({'/'.join(sorted(how))}): {names[0]} {a:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in got['new'])}), {names[1]} {b:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in got['first'])}) -> {a / b:.3f}x", flush=True)
    return a, b


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    S.phase_environment()
    S.phase_build()
    lib = build_first(Path(argv[0]).resolve())
    blocks_libs = build_blocks()
    dev = torch.device("cuda", 0)
    ok, timed = True, {}

    b = pt.CustomSceneBuilder()
    wcs = pt.compile_scene(b.build_scene(), device=dev)
    wblob = pack_scene_blob(wcs)
    o, d = S.whitted_camera_rays(wcs, b.create_camera(S.W_WIDTH / S.W_HEIGHT), S.N_RAYS, dev)
    lane = torch.arange(S.N_RAYS, device=dev)
    so, sd, bound = S.light_sample_rays(wcs, o, d, lane % wcs.n_lights)
    sets = [("Whitted camera rays", "closest", wcs, wblob, (o, d, T_MIN, 1e6)),
            ("one light-sample shadow ray a lane", "any", wcs, wblob, (so, sd, T_MIN, bound))]
    for n, seed in ((S.N_RAYS + 5, 1), (2 * S.N_RAYS + 5, 2)):
        ro, rd, rb = random_rays(n, seed, dev)
        for m in (n, 4133, 1):
            cut = (lambda x, m=m: x if m == n else x[:m].contiguous())
            co, cd = V3(*(cut(c) for c in ro)), V3(*(cut(c) for c in rd))
            for t_max in (1e6, 1e30, float("inf"), T_MIN):
                sets.append((f"random rays, {m} of {n}, t_max {t_max:g}", "closest", wcs, wblob,
                             (co, cd, T_MIN, t_max)))
            sets.append((f"random rays, {m} of {n}, per-ray bounds", "any", wcs, wblob,
                         (co, cd, T_MIN, cut(rb))))
    frames = {"oracle frame (320x240, 4 spp, depth 6)": frame_launches(
                  dev, S.O_WIDTH, S.O_HEIGHT, S.O_SPP, S.O_DEPTH),
              "CLI default through the oracle (2000x1500, 25 spp, depth 12)": frame_launches(
                  dev, S.W_WIDTH, S.W_HEIGHT, S.W_SPP, S.W_DEPTH, S.W_CHUNK)}
    level0 = []
    for fname, (cs, blob, launches) in frames.items():
        level = 0
        for kind, args in launches:
            n = args[0].x.shape[0]
            sets.append((f"{fname}, level {level}, {n} rays", kind, cs, blob, args))
            if level == 0:
                level0.append((f"{fname}, level 0, {n} rays", kind, cs, blob, args))
            level += kind == "any"

    for label, kind, cs, blob, args in sets:
        if kind == "closest":
            ok &= check(f"K3a, {label}", lambda: new_closest(cs, blob, *args),
                        lambda: first_closest(lib, cs, blob, *args))
        else:
            ok &= check(f"K3b, {label}", lambda: new_any(cs, blob, *args),
                        lambda: first_any(lib, cs, blob, *args))

    for label, kind, cs, blob, args in sets[:2] + level0:
        k = "K3a" if kind == "closest" else "K3b"
        new = ((lambda: new_closest(cs, blob, *args)) if kind == "closest"
               else (lambda: new_any(cs, blob, *args)))
        first = ((lambda: first_closest(lib, cs, blob, *args)) if kind == "closest"
                 else (lambda: first_any(lib, cs, blob, *args)))
        n = args[0].x.shape[0]
        print(f"[waves] {k}, {label}: {waves(lib, kind, cs, n, dev)}", flush=True)
        timed[f"{k}, {label}"] = in_turns(f"{k}, {label}", new, first,
                                          {"new": NEW[kind], "first": FIRST[kind]})
        both = {"new": NEW[kind], "first": NEW[kind]}
        for vname, ctx in (("records grid", records_grid),
                           (f"{MIN_BLOCKS[kind]} blocks",
                            lambda lib=blocks_libs[kind]: variant(lib))):
            with ctx():
                ok &= check(f"{k} {vname}, {label}", new, first)
            in_turns(f"{k}, {label}: kept / {vname}", new, (new, ctx), both,
                     ("kept", vname))
    print(S.card_line())
    ratios = {k: a / b for k, (a, b) in timed.items()}
    print(f"[summary] {len(timed)} rows in turns: new / first design "
          f"{min(ratios.values()):.3f}-{max(ratios.values()):.3f}x; {len(sets)} sets, every "
          f"lane bit-equal to the first design: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
