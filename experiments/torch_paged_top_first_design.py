#!/usr/bin/env python3
"""The PyTorch + CUDA port's paged top walks (K6a closest, K6b occlusion)
against their first designs, on one NVIDIA GPU: bit for bit on every lane
(K6a's seven record fields and its pending words ``plo``/``phi``; K6b's
found mask and pending words), timed in turns by device time per launch,
and the wrappers' host time per call.

The sets, each at 131,072 lanes (the config-6 path's own launch width: its
chunk of ``chunk_pixels`` lanes) and at a ragged 131,077:

* config 6 (``MeshSceneBuilder(5, 4)``): ``chip_smoke.py`` phase 12's spread
  camera rays and the first chunk three plain bounces on, K6a on the rays
  and K6b on their light-sample shadow rays (limits <= 0 where no answer
  is needed), and K6b again on the spread shadow rays with every 11th limit
  +inf and every 7th -1;
* the 512,000-triangle scene (``MeshSceneBuilder(5, 5)``, 50 pages): its
  spread camera rays and their shadow rays;
* the 48-page scene of ``chip_smoke.paged_48`` (``MeshSceneBuilder(2, 2)``
  with paging forced; its top leaves hold 168 triangles, the others' none):
  ``chip_smoke.rays_48``'s rays and limits (+inf and -1 among them).

Each set runs both variants of the redesign (``chip_smoke.top_variant``):
the top tree and slots staged in shared memory, as every scene here is,
and read from device memory.  The timed order is staged, device memory,
first design, first design, device memory, staged.

Host time: on config 6's spread rays, the wall time per call of each
wrapper over a run of calls that the card keeps up with, in turns (kept,
first, the kept wrapper made to set the library's argument types and ask
its plan, ``smem_limit`` and ``top_plan``, at every call; then in reverse),
beside ``chip_smoke.cuda_ms``'s call time of each.

The repository keeps no copy of the first designs.  Extract their sources
and wrapper from the commit that last had them into a directory and pass it:

    mkdir -p .scratch/first_top
    for f in csrc/bvh_paged.cu csrc/bvh_walk.cuh csrc/sweep.cuh ops/cuda/bvh_paged.py; do
      git show 86bcdb5:path_tracing__ray_tracer_tpu_torch/$f > .scratch/first_top/${f##*/}
    done
    python3 experiments/torch_paged_top_first_design.py .scratch/first_top

The kernels are built with the port's ``nvcc`` flags into ``DIR/build``
under another library name; they keep their own symbols
(``paged_top_closest_kernel``, ``paged_top_any_kernel``), so the profiler
tells them from the redesign's (``paged_top_closest_persistent``,
``paged_top_any_persistent``).  The first wrapper runs as a module of the
package with that library.  Prints each library's registers, stack and
spill (``ptxas -v``), the plans, resident blocks and grids, the card's name
and power limit; exits non-zero when any lane differs or a launch leaves
the lane counter nonzero.
"""
import ctypes
import importlib.util
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
from path_tracing__ray_tracer_tpu_torch.models.wavefront import chunk_pixels  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.cuda import build, bvh, bvh_paged  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3  # noqa: E402
from torch_page_walks_first_design import device_ms  # noqa: E402

RAGGED = S.N_RAYS + 5
HOST_CALLS = 200
_NEW = {"K6a": "paged_top_closest_persistent", "K6b": "paged_top_any_persistent"}
_FIRST = {"K6a": "paged_top_closest_kernel", "K6b": "paged_top_any_kernel"}


def first_wrapper(src: Path):
    """The first design's ``bvh_paged`` module, loaded from ``src`` as a
    module of the package, its ``build`` returning its own kernels built
    from ``src`` (the kept module's library is left alone)."""
    out = src / "build"
    out.mkdir(exist_ok=True)
    lib_path = out / "libfirst_paged.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path),
                           str(src / "bvh_paged.cu")], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    print("[build] first bvh_paged: " + "; ".join(
        x for x in S.ptxas_summary(log).split("; ") if "top" in x or "rror" in x), flush=True)
    if proc.returncode:
        raise SystemExit(log)
    name = "path_tracing__ray_tracer_tpu_torch.ops.cuda._first_bvh_paged"
    spec = importlib.util.spec_from_file_location(name, src / "bvh_paged.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    built = SimpleNamespace(lib=ctypes.CDLL(str(lib_path)), path=lib_path)
    own_build = mod.build

    def first_build():  # its own build(), which sets the argument types at every call
        real = build.load
        build.load = lambda _name: built
        try:
            return own_build()
        finally:
            build.load = real

    mod.build = first_build
    return mod


def leaves(x):
    return [x] if isinstance(x, torch.Tensor) else [t for part in x for t in leaves(part)]


def bit_equal(label, got, want) -> bool:
    ok = True
    for k, (a, b) in enumerate(zip(leaves(got), leaves(want))):
        if not S.same_bits(a, b):
            ok = False
            bad = a.view(torch.int32) != b.view(torch.int32) if a.is_floating_point() else a != b
            print(f"[bits]   {label}, output {k}: {int(bad.sum())} lanes differ", flush=True)
    return ok


def check(label, kernel, cs, new, first) -> bool:
    """Both variants against the first design, every output on every lane;
    the lane counter left zero."""
    want = first()
    ok = True
    for stage in (True, False):
        with S.top_variant(cs, stage):
            ok &= bit_equal(f"{kernel} {label} staged={stage}", new(), want)
    torch.cuda.synchronize()
    if bvh.lane_counter(torch.device("cuda", 0)).any():
        raise SystemExit("the top walks left the lane counter nonzero")
    print(f"[bits] {kernel} {label}: both variants bit-equal to the first design on every lane: "
          f"{ok}", flush=True)
    return ok


def in_turns(label, kernel, cs, new, first):
    """Device ms per launch: staged, device memory, first design, first
    design, device memory, staged."""
    order = (("staged", True), ("device memory", False), ("first design", None))
    got = {k: [] for k, _ in order}
    how = set()
    for k, stage in order + order[::-1]:
        if stage is None:
            ms, method = device_ms(first, _FIRST[kernel])
        else:
            with S.top_variant(cs, stage):
                ms, method = device_ms(new, _NEW[kernel])
        got[k].append(ms)
        how.add(method)
    mean = {k: statistics.mean(v) for k, v in got.items()}
    f = mean["first design"]
    print(f"[turns] {kernel} {label} ({'/'.join(sorted(how))}): " + "; ".join(
        f"{k} {mean[k]:.4f} ms ({', '.join(f'{x:.4f}' for x in got[k])}) -> {mean[k] / f:.3f}x"
        for k, _ in order), flush=True)
    return mean


def host_us(fn, calls=HOST_CALLS):
    """Wall microseconds per call over ``calls`` calls with no sync between
    them (the card runs each launch faster than the host makes the next)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def host_times(cs, o, d, so, sd, lim, first_mod):
    """The wrappers' host time per call in turns, and their call time: the
    kept wrapper, the first design's (which sets the library's argument
    types at every call), and the kept one made to set the types and ask
    its plan at every call (a wrapper that caches neither)."""
    def unplanned(call):
        def fn():
            bvh_paged._BOUND.clear()
            bvh_paged._TOP_PLANS.clear()
            return call()
        return fn

    wrappers = {
        "K6a": {"kept": lambda: bvh_paged.paged_top_closest(cs, o, d, 1e-3, 1e6),
                "first": lambda: first_mod.paged_top_closest(cs, o, d, 1e-3, 1e6)},
        "K6b": {"kept": lambda: bvh_paged.paged_top_any(cs, so, sd, 1e-3, lim),
                "first": lambda: first_mod.paged_top_any(cs, so, sd, 1e-3, lim)},
    }
    for kernel, w in wrappers.items():
        w["kept, types set and plan asked every call"] = unplanned(w["kept"])
        names = list(w)
        got = {k: [] for k in names}
        for k in names + names[::-1]:
            got[k].append(host_us(w[k]))
        call = {k: S.cuda_ms(w[k]) for k in names}
        print(f"[host] {kernel} config 6 spread, wall us per call over {HOST_CALLS} calls in "
              f"turns: " + "; ".join(
                  f"{k} {statistics.mean(got[k]):.2f} ({', '.join(f'{x:.2f}' for x in got[k])}), "
                  f"call time {call[k]:.4f} ms" for k in names), flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for _ in range(1000):
        torch.cuda.get_device_properties(dev)
    print(f"[host] torch.cuda.get_device_properties: "
          f"{1e3 * (time.perf_counter() - t0):.2f} us a call", flush=True)


def ragged(v, n):
    """The first ``n`` of ``v``'s lanes, its first lanes repeated past its end."""
    return V3(*(torch.cat([c, c[:n - c.shape[0]]]).contiguous() if n > c.shape[0]
                else c[:n].contiguous() for c in v))


def ragged1(x, n):
    return torch.cat([x, x[:n - x.shape[0]]]).contiguous() if n > x.shape[0] else x[:n].contiguous()


def run_sets(label, cs, sets, first_mod, timed):
    """``sets``: ``{name: (o, d, so, sd, lim)}``, each checked at N_RAYS and
    RAGGED lanes and timed at N_RAYS."""
    ok = True
    for staged in (True, False):
        with S.top_variant(cs, staged):
            print("[plans] " + label + ": " + "; ".join(
                f"{k} stage {p.stage}, class {p.depth_class}, {p.smem_bytes} B, {per_sm} blocks "
                f"of 256 a SM, grid {grid}"
                for k, (p, per_sm, grid) in S.top_walk_plans(cs).items()), flush=True)
    for name, (o, d, so, sd, lim) in sets.items():
        for n in (S.N_RAYS, RAGGED):
            oo, dd, sso, ssd, ll = (ragged(o, n), ragged(d, n), ragged(so, n), ragged(sd, n),
                                    ragged1(lim, n))
            key = f"{label} {name}, {n} lanes"
            calls = {
                "K6a": (lambda: bvh_paged.paged_top_closest(cs, oo, dd, 1e-3, 1e6),
                        lambda: first_mod.paged_top_closest(cs, oo, dd, 1e-3, 1e6)),
                "K6b": (lambda: bvh_paged.paged_top_any(cs, sso, ssd, 1e-3, ll),
                        lambda: first_mod.paged_top_any(cs, sso, ssd, 1e-3, ll)),
            }
            for kernel, (new, first) in calls.items():
                ok &= check(key, kernel, cs, new, first)
                if n == S.N_RAYS:
                    timed[f"{kernel} {key}"] = in_turns(key, kernel, cs, new, first)
    return ok


def with_edges(lim):
    lane = torch.arange(lim.shape[0], device=lim.device)
    return torch.where(lane % 11 == 0, float("inf"), torch.where(lane % 7 == 0, -1.0, lim))


def scenes(dev):
    """``(label, cs, sets)`` for config 6, the 512K scene and the 48-page
    scene in turn; ``sets``: ``{name: (o, d, so, sd, lim)}``, K6a on
    ``o, d`` and K6b on ``so, sd`` with limits ``lim``."""
    _scene, cam, cs, _secs = S.big_scene(dev, S.B_SUB)
    spread = S.camera_state(cs, cam, S.N_RAYS, dev, S.M_WIDTH, S.M_HEIGHT, S.M_DEPTH)
    chunk = S.camera_state(cs, cam, S.N_RAYS, dev, S.M_WIDTH, S.M_HEIGHT, S.M_DEPTH, stride=1)
    sets = {}
    for label, (o, d, _t, key, depth) in (("spread", spread),
                                          ("bounced", S.advance_plain(cs, chunk, 3))):
        so, sd, lim = S.mesh_shadow(cs, o, d, key, depth, bvh.scene_closest(cs, o, d, 1e-3, 1e6))
        print(f"[set] config 6 {label}: {int((lim > 0).sum())} of {S.N_RAYS} shadow rays need an "
              f"answer", flush=True)
        sets[label] = (o, d, so, sd, lim)
    o, d, so, sd, lim = sets["spread"]
    sets["spread, +inf and -1 limits"] = (o, d, so, sd, with_edges(lim))
    yield "config 6", cs, sets

    _scene, cam, cs, _secs = S.big_scene(dev, S.K512_SUB)
    o, d, _t, key, depth = S.camera_state(cs, cam, S.N_RAYS, dev, S.M_WIDTH, S.M_HEIGHT, S.M_DEPTH)
    so, sd, lim = S.mesh_shadow(cs, o, d, key, depth, bvh.scene_closest(cs, o, d, 1e-3, 1e6))
    yield "512K", cs, {"spread": (o, d, so, sd, lim)}

    cs = S.paged_48(dev)
    o, d, lim = S.rays_48(S.N_RAYS, 48, dev)
    yield "48 pages", cs, {"box rays": (o, d, o, d, lim)}


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    S.phase_environment()
    S.phase_build()
    print("[build] new bvh_paged: " + "; ".join(
        x for x in S.ptxas_summary(build.load("bvh_paged").log).split("; ") if "top" in x),
          flush=True)
    first_mod = first_wrapper(Path(argv[0]).resolve())
    dev = torch.device("cuda", 0)
    print(f"[width] the config-6 path launches K6a/K6b on "
          f"{chunk_pixels(S.M_WIDTH * S.M_HEIGHT, S.B_SPP, S.CHUNK_RAYS)} lanes "
          f"(chunk_pixels of its {S.M_WIDTH}x{S.M_HEIGHT} frame, {S.B_SPP}-sample group)",
          flush=True)
    ok, timed = True, {}
    for label, cs, sets in scenes(dev):
        if label == "config 6":
            host_times(cs, *sets["spread"], first_mod)
        ok &= run_sets(label, cs, sets, first_mod, timed)
        del cs, sets
        torch.cuda.empty_cache()

    print(S.card_line())
    for kernel in ("K6a", "K6b"):
        for k in ("staged", "device memory"):
            r = [v[k] / v["first design"] for key, v in timed.items() if key.startswith(kernel)]
            print(f"[summary] {kernel} {k}: {len(r)} sets in turns, new / first design "
                  f"{min(r):.3f}-{max(r):.3f}x")
        r = [v["staged"] / v["device memory"] for key, v in timed.items()
             if key.startswith(kernel)]
        print(f"[summary] {kernel} staged / device memory: {min(r):.3f}-{max(r):.3f}x")
    print(f"[summary] every lane bit-equal to the first designs: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
