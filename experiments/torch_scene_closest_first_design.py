#!/usr/bin/env python3
"""The PyTorch + CUDA port's whole-scene closest walks, K4a (the BVH4 walk
over slot records, ``bvh.scene_closest``) and K10a (the same walk with the
leaves tested by the leaf table, ``bvh_leafmat.scene_closest``), against
their first designs, on one NVIDIA GPU: all seven output fields bit for bit
on every lane, timed in turns (new, first design, first design, new) by
device time per launch.

The sets, on config 5 (``MeshSceneBuilder(3, 3)``) unless named:

* ``chip_smoke.py`` phase 19's rays: 131,072 camera rays over the 1920x1080
  frame, their secondary rays one plain bounce on, and rays from those
  origins aimed at random points of the mesh (every one hits); each at
  131,072, 131,077, 262,149 (past the resident lanes) and 518,400 lanes
  (its lanes repeated), with ``t_max`` 1e6, 1e30 (the oracle's) and
  ``+inf``; the camera rays also with the tree reported 20 deep (the deep
  stack class);
* the mesh Whitted frame (480x270, 4 spp, depth 16, ``chip_smoke.py``'s
  ``phase_mesh_whitted``): each of its K4a launches as the frame made it,
  518,400 lanes first, then the compacted bounces;
* K4a only: config 6's one-level tree (``MeshSceneBuilder(5, 4)``, its
  paged layout dropped) and the 512K scene's (``MeshSceneBuilder(5, 5)``,
  ids past 2^17), camera rays over the frame at 131,072 lanes, the three
  bounds.

Timed at 131,072 lanes (t_max 1e6) on the camera, secondary and aimed rays,
config 6's camera rays (K4a) and the Whitted frame's first launch; K10a
also against the redesigned K4a, its twin.  Beside the kept builds
(``__launch_bounds__(256, 2)``), the same sources asking for 3 and 4
resident blocks of 256 (``MIN_BLOCKS``; both spill, so neither can be
kept), bit-checked and timed in a palindrome against the kept build on the
three config-5 sets.  And the kept closest visit, which issues a batch's
four t·det loads only when one of its slots lies inside its triangle, as
the occlusion visit does, against the visit that issues all 19 together
(``ALL_LOADS_CLOSEST``, K10c's design until this redesign; built from the
current sources with it in place of ``MatQuadLeaf::closest``): bit-checked
and timed in turns on K10a (the palindrome above) and on K10c
(``bvh_leafmat.tri_closest``, a seed record with bound 1e6), which shares
the visit.

The repository keeps no copy of the first designs.  Extract their sources
from the commit that last had them into a directory and pass it:

    mkdir -p .scratch/first_scene_closest
    for f in bvh_scene.cu bvh_leafmat.cu bvh_walk.cuh sweep.cuh; do
      git show 41c504a:path_tracing__ray_tracer_tpu_torch/csrc/$f \\
        > .scratch/first_scene_closest/$f
    done
    python3 experiments/torch_scene_closest_first_design.py .scratch/first_scene_closest

Everything is built with the port's ``nvcc`` flags into ``DIR/build``, one
``nvcc`` a library, all at once; each first design gets an occupancy entry
appended to its copy (``first_closest_occupancy``).  Each time is the
kernel's device time per launch (``torch_page_walks_first_design.device_ms``).
Prints each build's registers, stack and spill (``ptxas -v``), each
design's resident blocks an SM and its waves at 131,072 and 518,400 lanes,
the depth classes, the card's name and power limit; exits non-zero when any
lane differs or the lane counter is left nonzero.
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
sys.path.insert(1, str(ROOT / "experiments"))

import chip_smoke as S  # noqa: E402
import path_tracing__ray_tracer_tpu_torch as pt  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.cuda import build, bvh, bvh_leafmat  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3  # noqa: E402
from torch_ordered_any_and_leafmat_first_design import leaf_sets, seed_record  # noqa: E402
from torch_page_walks_first_design import device_ms  # noqa: E402

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
T_MIN = 1e-3
MW_LANES = S.MW_WIDTH * S.MW_HEIGHT * S.MW_SPP  # the mesh Whitted frame's first launch
SIZES = (S.N_RAYS, S.N_RAYS + 5, 2 * S.N_RAYS + 5, MW_LANES)
BOUNDS = (1e6, 1e30, float("inf"))
MIN_BLOCKS = (3, 4)
# kernel -> (source, the redesign's symbol, the first design's symbol)
KERNELS = {"K4a": ("bvh_scene.cu", "bvh_closest_persistent", "bvh_closest_kernel"),
           "K10a": ("bvh_leafmat.cu", "mat_scene_closest_persistent", "mat_scene_closest_kernel")}
# The closest visit issuing a batch's 19 loads together, as K10c's earlier
# design did (dropped); each slot's decision expression for expression the
# kept visit's, which issues t·det's four loads only for a batch with a slot
# inside its triangle, so the record is the same.  K10a and K10c share it.
ALL_LOADS_CLOSEST = """\
  __device__ __forceinline__ void closest(float base, const Ray&, float t_min,
                                          int gid_offset, Hit& h) const {
    const float* col0 = mat + (size_t)base / kLeafSize * 128;
    int won = -1;
    for (int k = 0; k < kLeafSize; k += kSlotBatch) {
      float4 v[19];
      load_uv(col0, k, v);
      load_t(col0, k, v);
#pragma unroll
      for (int j = 0; j < kSlotBatch; ++j) {
        float det, un, vn, s2;
        if (!uv_inside(v, j, det, un, vn, s2)) continue;
        const float t = t_det(v, j) / det;
        if (t > t_min && t < h.t) {
          h.t = t;
          h.u = un / det;
          h.v = vn / det;
          won = k + j;
        }
      }
    }
    if (won >= 0) {
      const float* c9 = col0 + won + 9 * stride;
      h.prim = (int)__ldg(c9 + 112) + gid_offset;
      h.nx = __ldg(c9 + 64);
      h.ny = __ldg(c9 + 80);
      h.nz = __ldg(c9 + 96);
    }
  }
"""
ALL_LOADS = "K10a, all 19 loads together"
# the occupancy entry appended to each first design's copy
_FIRST_OCC = """
extern "C" int first_closest_occupancy(int smem, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ptrt::%s, 128, smem);
}
"""


def _stream():
    return torch.cuda.current_stream().cuda_stream


def sources(first: Path, out: Path) -> dict:
    """``{label: (kernel, source path)}``: each first design with its
    occupancy entry, the current sources as they are (``kept``) and asking
    for ``MIN_BLOCKS``, and the current ``bvh_leafmat.cu`` with
    ``ALL_LOADS_CLOSEST`` (``ALL_LOADS``)."""
    jobs = {}
    for k, (src, new_sym, first_sym) in KERNELS.items():
        path = out / "first" / src
        path.parent.mkdir(parents=True, exist_ok=True)
        for f in ("bvh_walk.cuh", "sweep.cuh"):
            (path.parent / f).write_text((first / f).read_text())
        path.write_text((first / src).read_text() + _FIRST_OCC % first_sym)
        jobs[f"first {k}"] = (k, path)
        text = (build.CSRC / src).read_text()
        path = out / "kept" / src  # built for its ptxas report only
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        jobs[f"kept {k}"] = (k, path)
        kept = f"__launch_bounds__(kWalkThreads, 2)\n{new_sym}("
        if text.count(kept) != 1:
            raise SystemExit(f"{src}: the launch bounds of {new_sym} are not where expected")
        for blocks in MIN_BLOCKS:
            path = out / f"blocks{blocks}" / src
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(text.replace(kept, kept.replace(", 2)", f", {blocks})")))
            jobs[f"{k}, {blocks} blocks"] = (k, path)
    walk = (build.CSRC / "bvh_walk.cuh").read_text()
    start = walk.index("  __device__ __forceinline__ void closest(",
                       walk.index("struct MatQuadLeaf : MatLeaf {"))
    end = walk.index("\n  // Any slot hit with", start)
    path = out / "all_loads" / "bvh_leafmat.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    (path.parent / "bvh_walk.cuh").write_text(walk[:start] + ALL_LOADS_CLOSEST + walk[end:])
    (path.parent / "sweep.cuh").write_text((build.CSRC / "sweep.cuh").read_text())
    path.write_text((build.CSRC / "bvh_leafmat.cu").read_text())
    jobs[ALL_LOADS] = ("K10a", path)
    return jobs


def build_all(first: Path) -> dict:
    """Compile every library of :func:`sources` at once (``-I`` the port's
    headers, which the first designs' copies shadow) and print each one's
    ptxas summary; ``{label: (kernel, CDLL)}`` of all but the kept builds
    (the wrappers launch the package's own)."""
    out = first / "build"
    jobs = {}
    t0 = time.perf_counter()
    for label, (k, src) in sources(first, out).items():
        lib_path = src.parent / f"lib{src.stem}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib_path),
               str(src)]
        jobs[label] = (k, lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (k, lib_path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(log)
        symbol = KERNELS[k][2 if label.startswith("first") else 1]
        rows = [x for x in S.ptxas_summary(log).split("; ") if x.startswith(symbol)]
        print(f"[ptxas] {label}: {'; '.join(rows)}", flush=True)
        if not label.startswith("kept"):
            libs[label] = (k, ctypes.CDLL(str(lib_path)))
    print(f"[build] {len(libs)} libraries, nvcc in parallel: {time.perf_counter() - t0:.2f} s "
          "wall", flush=True)
    kept = {"K4a": bvh.build().lib, "K10a": bvh_leafmat.build().lib}
    entries = {"K4a": ("ptrt_bvh_closest", "ptrt_bvh_closest_occupancy"),
               "K10a": ("ptrt_mat_scene_closest", "ptrt_mat_scene_closest_occupancy")}
    rays_out = [_P] * 6 + [_I, _I, _F, _F] + [_P] * 7 + [_P]
    for label, (k, lib) in libs.items():
        if label.startswith("first"):
            fn = getattr(lib, entries[k][0])
            fn.argtypes = ([_P, _I, _P, _P, _I, _I, _I] if k == "K4a"
                           else [_P, _I, _P, _L, _P, _I, _I, _I]) + rays_out
            lib.first_closest_occupancy.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
            for f in (fn, lib.first_closest_occupancy):
                f.restype = ctypes.c_int
        else:
            names = entries[k] + (("ptrt_mat_tri_closest", "ptrt_mat_tri_closest_occupancy")
                                  if label == ALL_LOADS else ())
            for name in names:
                fn, bound = getattr(lib, name), getattr(kept[k], name)
                fn.argtypes, fn.restype = bound.argtypes, bound.restype
    return libs


# ---- the kernels' seven fields ------------------------------------------------------
@contextlib.contextmanager
def raw_fields():
    """The scene walks' wrappers return their kernel's seven output fields
    ``(t, prim, u, v, nx, ny, nz)`` as it wrote them, not the ``SceneHit``
    that ``bvh._fused_hit`` makes of them."""
    saved = bvh._fused_hit, bvh_leafmat._fused_hit

    def raw(_cs, _ro, _rd, t, prim, u, v, normal):
        return (t, prim, u, v, *normal)

    bvh._fused_hit = bvh_leafmat._fused_hit = raw
    try:
        yield
    finally:
        bvh._fused_hit, bvh_leafmat._fused_hit = saved


def new_closest(k, cs, o, d, t_min, t_max):
    """The redesign's seven fields through its wrapper (the lane counter
    checked zero after it)."""
    with raw_fields():
        if k == "K4a":
            return bvh.scene_closest(cs, o, d, t_min, t_max)
        return bvh_leafmat.scene_closest(cs, o, d, t_min, t_max)


def first_closest(k, lib, cs, o, d, t_min, t_max):
    """The first design's seven fields from its C entry."""
    n = o.x.shape[0]
    out = torch.empty((6, n), dtype=torch.float32, device=o.x.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.x.device)
    t, u, v, nx, ny, nz = out
    b = cs.bvh
    head = ((b.nodes4.data_ptr(), b.nodes4.shape[0] // 32, b.slot_rec.data_ptr())
            if k == "K4a" else (b.nodes4.data_ptr(), b.nodes4.shape[0] // 32,
                                b.leaf_mat.data_ptr(), b.leaf_mat.shape[1]))
    err = getattr(lib, "ptrt_bvh_closest" if k == "K4a" else "ptrt_mat_scene_closest")(
        *head, b.ps_blob.data_ptr(), cs.n_planes, cs.n_spheres, cs.n_quads,
        *(x.data_ptr() for x in (*o, *d)), n, bvh.gid_mask(cs), float(t_min), float(t_max),
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), nx.data_ptr(), ny.data_ptr(),
        nz.data_ptr(), _stream())
    bvh._raise_on(f"first {k}", err)
    return t, prim, u, v, nx, ny, nz


@contextlib.contextmanager
def variant(k, lib):
    """``k``'s wrapper launching ``lib``'s kernel, its grid asked of its own
    occupancy entry."""
    mod = bvh if k == "K4a" else bvh_leafmat
    saved, resident = mod.build, dict(bvh._RESIDENT)
    mod.build = lambda: SimpleNamespace(lib=lib)
    bvh._RESIDENT.clear()
    try:
        yield
    finally:
        mod.build = saved
        bvh._RESIDENT.clear()
        bvh._RESIDENT.update(resident)


def under(k, lib, call):
    """``call()`` with ``k``'s wrapper launching ``lib``'s kernels."""
    with variant(k, lib):
        return call()


def record(r):
    """A ``ClosestRecord``'s seven fields."""
    return (r.t, r.prim, r.u, r.v, *r.normal)


def check(label, got, want) -> bool:
    torch.cuda.synchronize()
    eq = len(got) == len(want) == 7 and all(S.same_bits(a, b) for a, b in zip(got, want))
    hits = int((got[1] >= 0).sum())
    print(f"[bits] {label}: all seven fields bit-equal on every lane: {eq} ({hits} of "
          f"{got[1].numel()} lanes hit)", flush=True)
    if bvh.lane_counter(torch.device("cuda", 0)).any():
        raise SystemExit("the persistent walks left the lane counter nonzero")
    return eq


def lanes_of(v: V3, n: int) -> V3:
    """``n`` lanes of ``v``: its lanes repeated from the first past its end."""
    k = torch.arange(n, device=v.x.device) % v.x.shape[0]
    return V3(*(c[k].contiguous() for c in v))


# ---- occupancy and waves ------------------------------------------------------------
def waves(libs, cs, dev):
    """Each design's resident blocks an SM and its waves (first designs:
    blocks of 128 over the resident ones; redesigns: lanes over the
    persistent grid's lanes)."""
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem = 4 * cs.bvh.ps_blob.numel()
    plan = bvh.closest_plan(cs)
    for k in KERNELS:
        blocks = ctypes.c_int(0)
        lib = libs[f"first {k}"][1]
        bvh._raise_on(k, lib.first_closest_occupancy(smem, ctypes.byref(blocks)))
        per_sm = blocks.value
        parts = [f"first design {per_sm} blocks of 128 an SM"] + [
            f"{n} lanes: {-(-n // 128)} blocks, {-(-n // 128) / (per_sm * n_sms):.2f} waves"
            for n in (S.N_RAYS, MW_LANES)]
        kept = [("kept", bvh.build().lib if k == "K4a" else bvh_leafmat.build().lib)] + [
            (label, v[1]) for label, v in libs.items()
            if v[0] == k and not label.startswith("first")]
        for label, klib in kept:
            occupancy = getattr(klib, "ptrt_bvh_closest_occupancy" if k == "K4a"
                                else "ptrt_mat_scene_closest_occupancy")
            got = ctypes.c_int(0)
            bvh._raise_on(label, occupancy(0, plan.depth_class, plan.smem_bytes,
                                           ctypes.byref(got)))
            grid = bvh.persistent_grid(S.N_RAYS, n_sms, got.value)
            parts.append(f"{label}: {got.value} blocks of 256 an SM, grid {grid} at "
                         f"{S.N_RAYS} lanes ({S.N_RAYS / (grid * 256):.2f} lane passes), "
                         f"{MW_LANES / (n_sms * got.value * 256):.2f} at {MW_LANES}")
        print(f"[occupancy] {k}: " + "; ".join(parts), flush=True)


# ---- timing -------------------------------------------------------------------------
def in_turns(label, a, b, names=("new", "first design")):
    """Device ms per launch of ``a`` and ``b`` (each ``(call, symbol)``),
    timed a, b, b, a."""
    got = {names[0]: [], names[1]: []}
    how = set()
    for name, (fn, symbol) in ((names[0], a), (names[1], b), (names[1], b), (names[0], a)):
        ms, method = device_ms(fn, symbol)
        got[name].append(ms)
        how.add(method)
    ma, mb = (statistics.mean(v) for v in got.values())
    print(f"[turns] {label} ({'/'.join(sorted(how))}): {names[0]} {ma:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in got[names[0]])}), {names[1]} {mb:.4f} ms "
          f"({', '.join(f'{x:.4f}' for x in got[names[1]])}) -> {ma / mb:.3f}x", flush=True)
    return ma / mb


def variant_turns(label, k, libs, cs, o, d) -> bool:
    """The kept build and each variant of ``k`` (kept or not: a build that
    spills is timed to say what more resident warps would buy), timed in a
    palindrome, each variant's bits against the kept build's."""
    builds = {lab: v[1] for lab, v in libs.items() if v[0] == k and not lab.startswith("first")}
    call = (lambda: new_closest(k, cs, o, d, T_MIN, 1e6))
    want = call()
    got = {None: [], **{lab: [] for lab in builds}}
    ok = True
    for lab in (None, *builds, *reversed(tuple(builds)), None):
        with variant(k, builds[lab]) if lab else contextlib.nullcontext():
            if lab and not got[lab]:
                ok &= check(f"{k} {lab}, {label}", call(), want)
            got[lab].append(device_ms(call, KERNELS[k][1])[0])
    kept = statistics.mean(got[None])
    print(f"[variant] {k}, {label}: kept (2 blocks) {kept:.4f} ms; " + "; ".join(
        f"{lab} {statistics.mean(v):.4f} ms ({statistics.mean(v) / kept:.3f}x)"
        for lab, v in got.items() if lab) + f"; bit-equal {ok}", flush=True)
    return ok


# ---- the sets -----------------------------------------------------------------------
def whitted_launches(dev):
    """Each K4a launch of the mesh Whitted frame as ``(cs, o, d, t_min,
    t_max)``, its rays copied."""
    b = pt.MeshSceneBuilder(grid=3, subdivisions=3)
    scene, cam = b.build_scene(), b.create_camera(S.MW_WIDTH / S.MW_HEIGHT)
    r = pt.RendererFactory.create("cuda_texture_raytracer", seed=0, device=dev)
    seen = []
    real = bvh._fused_closest

    def spy(cs, ro, rd, t_min, t_max):
        seen.append((cs, V3(*(x.clone().contiguous() for x in ro)),
                     V3(*(x.clone().contiguous() for x in rd)), t_min, t_max))
        return real(cs, ro, rd, t_min, t_max)

    bvh._fused_closest = spy
    try:
        r.render_sums(scene, cam, pt.RenderSettings(S.MW_WIDTH, S.MW_HEIGHT, S.MW_SPP,
                                                    S.MW_DEPTH))
    finally:
        bvh._fused_closest = real
    torch.cuda.synchronize()
    print(f"[whitted] the mesh Whitted frame launched K4a {len(seen)} times: lanes "
          f"{[x[1].x.shape[0] for x in seen]}, (t_min, t_max) {sorted({x[3:] for x in seen})}",
          flush=True)
    return seen


def big_flat(dev, subdivisions):
    """A big mesh scene's one-level tree and its camera rays over the frame."""
    _scene, cam, cs, secs = S.big_scene(dev, subdivisions)
    flat = S.one_level(cs)
    o, d, _t, _key, _depth = S.camera_state(cs, cam, S.N_RAYS, dev, S.M_WIDTH, S.M_HEIGHT,
                                            S.M_DEPTH)
    plan = bvh.closest_plan(flat)
    print(f"[scene] MeshSceneBuilder({S.B_GRID}, {subdivisions}): {flat.n_triangles} triangles, "
          f"BVH4 {flat.bvh.nodes4.shape[0] // 32} nodes, depth {flat.bvh.depth4} -> K4a depth "
          f"class {plan.depth_class}; gid mask {bvh.gid_mask(flat)}, gids past 2^17: "
          f"{bool((flat.bvh.slot_rec.view(-1, 13)[:, 9] >= 2 ** 17).any())}; compile "
          f"{secs:.2f} s", flush=True)
    return flat, o, d


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    S.phase_environment()
    S.phase_build()
    libs = build_all(Path(argv[0]).resolve())
    first = {k: libs[f"first {k}"][1] for k in KERNELS}
    dev = torch.device("cuda", 0)
    _scene, cam, cs = S.mesh_scene(dev)
    deep = cs._replace(bvh=cs.bvh._replace(depth4=20))
    print(f"[plans] config 5: depth4 {cs.bvh.depth4} -> {tuple(bvh.closest_plan(cs))} (K10a "
          f"{tuple(bvh_leafmat.scene_any_plan(cs))}); reported 20 deep -> "
          f"{tuple(bvh.closest_plan(deep))}", flush=True)
    waves(libs, cs, dev)
    ok = True
    sets = {label: (o, d) for label, o, d, _key, _depth in leaf_sets(cs, cam, dev)}
    for k in KERNELS:
        for label, (o, d) in sets.items():
            for n in SIZES:
                oo, dd = lanes_of(o, n), lanes_of(d, n)
                for t_max in BOUNDS:
                    ok &= check(f"{k}, {label}, {n} lanes, t_max {t_max:g}",
                                new_closest(k, cs, oo, dd, T_MIN, t_max),
                                first_closest(k, first[k], cs, oo, dd, T_MIN, t_max))
        o, d = sets["camera rays"]
        for t_max in BOUNDS:
            ok &= check(f"{k}, camera rays, class 32 (reported 20 deep), t_max {t_max:g}",
                        new_closest(k, deep, o, d, T_MIN, t_max),
                        first_closest(k, first[k], deep, o, d, T_MIN, t_max))
    launches = whitted_launches(dev)
    for k in KERNELS:
        for j, (c, o, d, t_min, t_max) in enumerate(launches):
            ok &= check(f"{k}, the mesh Whitted frame's launch {j + 1}, {o.x.shape[0]} lanes",
                        new_closest(k, c, o, d, t_min, t_max),
                        first_closest(k, first[k], c, o, d, t_min, t_max))
    big = {}
    for name, sub in (("config 6", S.B_SUB), ("512K", S.K512_SUB)):
        flat, o, d = big_flat(dev, sub)
        for t_max in BOUNDS:
            ok &= check(f"K4a, {name} one-level tree, camera rays, t_max {t_max:g}",
                        new_closest("K4a", flat, o, d, T_MIN, t_max),
                        first_closest("K4a", first["K4a"], flat, o, d, T_MIN, t_max))
        if name == "config 6":
            big[name] = (flat, o, d)
        else:
            del flat
            torch.cuda.empty_cache()

    ratios, twins = {}, {}
    timed = {f"{label}, t_max 1e6": (cs, o, d, T_MIN, 1e6) for label, (o, d) in sets.items()}
    c0, o0, d0, tn0, tx0 = launches[0]
    timed[f"the mesh Whitted frame's first launch, {o0.x.shape[0]} lanes"] = (c0, o0, d0, tn0,
                                                                             tx0)
    for k in KERNELS:
        rows = dict(timed)
        if k == "K4a":
            flat, o, d = big["config 6"]
            rows["config 6's one-level tree, camera rays, t_max 1e6"] = (flat, o, d, T_MIN, 1e6)
        for label, (c, o, d, tn, tx) in rows.items():
            ratios[f"{k}, {label}"] = in_turns(
                f"{k}, {label}",
                (lambda k=k, c=c, o=o, d=d, tn=tn, tx=tx: new_closest(k, c, o, d, tn, tx),
                 KERNELS[k][1]),
                (lambda k=k, c=c, o=o, d=d, tn=tn, tx=tx: first_closest(k, first[k], c, o, d, tn,
                                                                       tx), KERNELS[k][2]))
    for label, (c, o, d, tn, tx) in timed.items():
        twins[label] = in_turns(
            f"K10a against the redesigned K4a, {label}",
            (lambda c=c, o=o, d=d, tn=tn, tx=tx: new_closest("K10a", c, o, d, tn, tx),
             KERNELS["K10a"][1]),
            (lambda c=c, o=o, d=d, tn=tn, tx=tx: new_closest("K4a", c, o, d, tn, tx),
             KERNELS["K4a"][1]), ("K10a", "K4a"))
    for k in KERNELS:
        for label, (o, d) in sets.items():
            ok &= variant_turns(label, k, libs, cs, o, d)
    for label, (o, d) in sets.items():  # K10c shares the closest visit
        seed = seed_record(torch.full((o.x.shape[0],), 1e6, device=dev))
        kept = (lambda o=o, d=d, seed=seed: bvh_leafmat.tri_closest(cs, o, d, T_MIN, seed))
        all19 = (lambda kept=kept: under("K10a", libs[ALL_LOADS][1], kept))
        ok &= check(f"K10c with all 19 loads together, {label}", record(all19()), record(kept()))
        in_turns(f"K10c, {label}", (kept, "mat_tri_closest_persistent"),
                 (all19, "mat_tri_closest_persistent"), ("kept", "all 19 loads together"))
    print(S.card_line())
    for name, rows in (("new / first design", ratios), ("K10a / K4a twins", twins)):
        print(f"[summary] {name}: {len(rows)} rows in turns, {min(rows.values()):.3f}-"
              f"{max(rows.values()):.3f}x (mean of rows {statistics.mean(rows.values()):.3f})")
    print(f"[summary] every lane bit-equal to the first designs and the variants: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
