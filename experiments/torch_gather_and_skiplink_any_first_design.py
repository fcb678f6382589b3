#!/usr/bin/env python3
"""The PyTorch + CUDA port's skip-link BVH2 occlusion walk (K4e) and texel
gather (K8/K9) against their first designs, on one NVIDIA GPU: bit for bit
on every lane, timed in turns by device time per launch, and the gather
beside its launch floor.

The skip-link occlusion walk (``bvh2_any_skiplink_persistent`` against
the first design's ``bvh2_any_kernel``), on config 5
(``MeshSceneBuilder(3, 3)``) and ``chip_smoke.py`` phase 19's rays:

* the light-sample shadow rays of 131,072 camera rays over the 1920x1080
  frame (``chip_smoke.mesh_shadow``: lanes that need no answer carry −1);
  the same with every 11th limit ``+inf`` and every 7th −1;
* the secondary rays one plain bounce on, limited by a per-ray bound
  about half of them reach; the rays aimed at the mesh, limit 1e6;
* the 190-deep BVH2 chain of ``tests/torch_chain.py`` at 131,072 and 4,133
  rays, limited by a per-ray bound.

Each set is checked at 131,072, 131,077 and 262,149 lanes (the last past
the resident blocks' lanes: later lanes come from the lane counter) and
timed at 131,072 in turns (new, first design, first design, new).  The
walk is also timed in turns beside variants built from the current
``bvh2_walk.cu``: launch bounds asking for 4 resident blocks of 256 (at most
64 registers), the same with ``Slot16LeafT`` reading two slots a batch (in
a copy of ``bvh_walk.cuh``), and a per-lane refill (``REFILL_BODY``: one
node a trip, a thread whose ray has ended taking its next lane at once
through a warp-aggregated ``atomicAdd`` on the same counter), each
bit-equal to the kept walk, at 131,072 lanes and at 262,149.

The gather: the kept kernel (the first design, ``gather_rgb_kernel``, one
lane a thread; no redesign beat it) against its build from git and the
multi-lane designs tried for it (``LANES_SRC``, ``gather_rgb_lanes``: a
thread takes ``kGatherLanes`` lanes with one 16-byte index load, its texel
loads issued together and one 16-byte store into each output row; a scalar
head up to the first index at a 16-byte boundary and a scalar tail; the
output rows placed at the index's alignment by ``lane_rows``), on the
Cornell box's texel indices: K1's first hits of 131,072 camera rays spread
over the 1024² frame, into the atlas at the atlas route's budget (K8), the
defer64 mip and the LOD mip (K9); and on random indices below 0, past the
texels and past 128·R.  Bits at 131,072 and 131,077 lanes, at 1 and 5, and
on the index view ``idx[1:]`` (the multi-lane designs' head lanes).  Timed
in turns, each in a palindrome over ``ROUNDS`` rounds: the kept kernel,
its first design, the multi-lane designs at the lanes a thread and block
sizes of ``GATHER_VARIANTS``, and the floor kernels on the kept kernel's
grid (512 blocks of 256 at 131,072 lanes): ``floor_empty`` (no work) and
``floor_copy`` (the index in, three floats out, no texel read).  A design
beats the first only if its slowest time is below the first design's
fastest on each of the main path's three gathers (``MAIN_GATHERS``).

The repository keeps no copy of the first designs.  Extract their sources
from the commit that last had them into a directory and pass it:

    mkdir -p .scratch/first_gather_any
    for f in bvh2_walk.cu texture_gather.cu bvh_walk.cuh sweep.cuh; do
      git show f75eb47:path_tracing__ray_tracer_tpu_torch/csrc/$f > .scratch/first_gather_any/$f
    done
    python3 experiments/torch_gather_and_skiplink_any_first_design.py .scratch/first_gather_any

Everything is built with the port's ``nvcc`` flags into ``DIR/build``, one
``nvcc`` a library, all at once.  Each time is the kernel's device time per
launch (``torch_page_walks_first_design.device_ms``).  Prints each
library's registers, stack and spill (``ptxas -v``), the walks' resident
blocks an SM, the card's name and power limit; exits non-zero when any lane
differs.
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
from path_tracing__ray_tracer_tpu_torch.ops import bvh as tbvh  # noqa: E402
from path_tracing__ray_tracer_tpu_torch.ops.cuda import (  # noqa: E402
    bounce, build, bvh, bvh2, texture)
from path_tracing__ray_tracer_tpu_torch.ops.v3 import V3  # noqa: E402
from torch_chain import chain_rays, chain_scene  # noqa: E402
from torch_ordered_any_and_leafmat_first_design import half_bound  # noqa: E402
from torch_page_walks_first_design import device_ms  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
T_MIN = 1e-3
SIZES = (S.N_RAYS, S.N_RAYS + 5, 2 * S.N_RAYS + 5)
CHAIN_SMALL = 4096 + 37
ROUNDS = 3
NEW_ANY, FIRST_ANY = "bvh2_any_skiplink_persistent", "bvh2_any_kernel"
KEPT_GATHER, LANES_GATHER = "gather_rgb_kernel", "gather_rgb_lanes"

_ANY_BOUNDS = "__launch_bounds__(kWalkThreads)\nbvh2_any_skiplink_persistent("
_SLOT_BATCH = "constexpr int kSlotBatch = 4;"
_LANES = "constexpr int kGatherLanes = 4;"
_THREADS = "constexpr int kGatherThreads = 256;"
# (lanes a thread, threads a block) of the multi-lane gathers
GATHER_VARIANTS = ((4, 256), (4, 128), (4, 64), (2, 256), (2, 128))
# the main path's gathers: the kept design must beat the first on each
MAIN_GATHERS = ("K8, atlas", "K9, defer64 mip", "K9, LOD mip")

# The per-lane refill: the kept kernel's body, one node (or leaf) a trip
REFILL_BODY = """
  const Slot16TriLeaf leaf{reinterpret_cast<const float4*>(slot16)};
  WalkRay w;
  float limit = 0.0f;
  int i = 0, cursor = 0, step = 0;
  bool fetch = true;
  for (;;) {
    if (fetch) {  // this thread's next lane; the threads fetching together share one atomicAdd
      const cooperative_groups::coalesced_group g = cooperative_groups::coalesced_threads();
      int base = 0;
      if (g.thread_rank() == 0) base = atomicAdd(counter, (int)g.size());
      i = g.shfl(base, 0) + (int)g.thread_rank();
      if (i >= n) break;
      limit = limit_in[i];
      if (limit <= 0.0f) {
        occ_out[i] = 1;
        continue;
      }
      w = walk_ray(load_ray(ox_in, oy_in, oz_in, dx_in, dy_in, dz_in, i));
      cursor = 0;
      step = 0;
      fetch = false;
    }
    if (!(cursor < m && step <= m)) {  // the walk's end: no hit below the limit
      occ_out[i] = 0;
      fetch = true;
      continue;
    }
    const float4* p = reinterpret_cast<const float4*>(tree + (size_t)cursor * kNode2F);
    const float4 lo = __ldg(p), hi = __ldg(p + 1);
    const float b[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
    const bool hit = slab(b, w, t_min, limit);
    const float code = hi.w;
    if (hit && code >= 0.0f && leaf.any(code, w.r, t_min, limit)) {
      occ_out[i] = 1;
      fetch = true;
      continue;
    }
    cursor = (hit && code < 0.0f) ? cursor + 1 : (int)hi.z;
    ++step;
  }
"""

# The multi-lane gather: kGatherLanes lanes a thread, the same arithmetic as
# the kept kernel (csrc/texture_gather.cu), its C entries under the same names
# with the rows' stride added
LANES_SRC = r"""
#include <cuda_runtime.h>

#include <cstdint>

namespace ptrt {

constexpr int kGatherThreads = 256;
constexpr int kGatherLanes = 4;

__device__ __forceinline__ int texel_at(const int* __restrict__ table, int n_texels, int last,
                                        int index) {
  const int k = min(max(index, 0), last);
  return k < n_texels ? __ldg(table + k) : 0;
}

__device__ __forceinline__ float channel(int texel, int shift) {
  return (float)((texel >> shift) & 0xFF) * (float)(1.0 / 255.0);
}

__device__ __forceinline__ void load_lanes(const int* p, int (&k)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
}

__device__ __forceinline__ void load_lanes(const int* p, int (&k)[2]) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  k[0] = v.x; k[1] = v.y;
}

__device__ __forceinline__ void store_lanes(float* p, const float (&c)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(c[0], c[1], c[2], c[3]);
}

__device__ __forceinline__ void store_lanes(float* p, const float (&c)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(c[0], c[1]);
}

// the first index at a (4 kGatherLanes)-byte boundary, or n: the head's lanes
inline int gather_head(const int* idx, int n) {
  const int phase = (int)((reinterpret_cast<uintptr_t>(idx) / sizeof(int)) % kGatherLanes);
  const int head = (kGatherLanes - phase) % kGatherLanes;
  return head < n ? head : n;
}

// threads [0, groups) take the groups of kGatherLanes lanes after the head,
// the next head + tail threads one scalar lane each
__global__ void __launch_bounds__(kGatherThreads)
gather_rgb_lanes(const int* __restrict__ table, int n_texels, const int* __restrict__ idx_in,
                 float* __restrict__ out, int stride, int n, int head, int groups) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int last = ((n_texels + 127) / 128) * 128 - 1;
  const size_t S = (size_t)stride;
  if (t < groups) {
    const int i = head + t * kGatherLanes;
    int k[kGatherLanes];
    load_lanes(idx_in + i, k);
    int texel[kGatherLanes];
#pragma unroll
    for (int j = 0; j < kGatherLanes; ++j) texel[j] = texel_at(table, n_texels, last, k[j]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v[kGatherLanes];
#pragma unroll
      for (int j = 0; j < kGatherLanes; ++j) v[j] = channel(texel[j], 8 * c);
      store_lanes(out + c * S + i, v);
    }
    return;
  }
  const int s = t - groups;
  const int i = s < head ? s : head + groups * kGatherLanes + (s - head);
  if (i >= n) return;
  const int texel = texel_at(table, n_texels, last, idx_in[i]);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * S + i] = channel(texel, 8 * c);
}

}  // namespace ptrt

// rows `stride` floats apart, each row's lane i at the index's alignment
extern "C" int ptrt_atlas_gather(const int* table, int n_texels, const int* idx, float* out,
                                 int stride, int n, void* stream) {
  using namespace ptrt;
  if (n <= 0) return (int)cudaSuccess;
  const uintptr_t a = reinterpret_cast<uintptr_t>(idx), b = reinterpret_cast<uintptr_t>(out);
  if (a % sizeof(int) || (a - b) % (sizeof(int) * kGatherLanes) || stride % kGatherLanes ||
      stride < n)
    return (int)cudaErrorInvalidValue;
  const int head = gather_head(idx, n);
  const int groups = (n - head) / kGatherLanes;
  const int threads = groups + (n - groups * kGatherLanes);
  gather_rgb_lanes<<<(threads + kGatherThreads - 1) / kGatherThreads, kGatherThreads, 0,
                     (cudaStream_t)stream>>>(table, n_texels, idx, out, stride, n, head, groups);
  return (int)cudaGetLastError();
}
"""

FLOOR_SRC = r"""
#include <cuda_runtime.h>

namespace ptrt {

__global__ void __launch_bounds__(256) floor_empty() {}

__global__ void __launch_bounds__(256)
floor_copy(const int* __restrict__ idx, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = idx[i];
  const size_t N = (size_t)n;
  out[i] = (float)(k & 0xFF) * (float)(1.0 / 255.0);
  out[N + i] = (float)((k >> 8) & 0xFF) * (float)(1.0 / 255.0);
  out[2 * N + i] = (float)((k >> 16) & 0xFF) * (float)(1.0 / 255.0);
}

}  // namespace ptrt

extern "C" int ptrt_floor_empty(int n, void* stream) {
  ptrt::floor_empty<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int ptrt_floor_copy(const int* idx, float* out, int n, void* stream) {
  ptrt::floor_copy<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(idx, out, n);
  return (int)cudaGetLastError();
}
"""


def _stream():
    return torch.cuda.current_stream().cuda_stream


def variant_sources(out: Path) -> dict:
    """``{label: source path}`` of every library to build: the first
    designs (beside their own headers), the walk's and the gather's variants
    (each in a directory of its own, with any header it edits; the others
    from ``csrc/``), and the floor kernels."""
    made = {f"first {name}": out.parent / f"{name}.cu" for name in ("bvh2_walk", "texture_gather")}
    walk = (build.CSRC / "bvh2_walk.cu").read_text()
    walk_header = (build.CSRC / "bvh_walk.cuh").read_text()
    assert _ANY_BOUNDS in walk and _SLOT_BATCH in walk_header
    four = walk.replace(_ANY_BOUNDS, _ANY_BOUNDS.replace(")", ", 4)", 1))
    texts = {
        "walk, 4 blocks": {"bvh2_walk.cu": four},
        "walk, 4 blocks, batches of two slots": {"bvh2_walk.cu": four,
                                                 "bvh_walk.cuh": two_slot_batches(walk_header)},
        "walk, per-lane refill": {"bvh2_walk.cu": refill_source(walk)},
    }
    assert _LANES in LANES_SRC and _THREADS in LANES_SRC
    for lanes, threads in GATHER_VARIANTS:
        texts[f"gather, {lanes} lanes, blocks of {threads}"] = {"texture_gather_lanes.cu": (
            LANES_SRC.replace(_LANES, _LANES.replace("4", str(lanes)))
            .replace(_THREADS, _THREADS.replace("256", str(threads))))}
    texts["floor"] = {"floor.cu": FLOOR_SRC}
    for label, files in texts.items():
        where = out / label.replace(",", "").replace(" ", "_")
        where.mkdir(exist_ok=True)
        for name, text in files.items():
            (where / name).write_text(text)
        made[label] = where / next(iter(files))
    return made


def two_slot_batches(header: str) -> str:
    """``bvh_walk.cuh`` with ``Slot16LeafT`` reading two slots a batch (the
    leaf-table visits keep their four)."""
    a = header.index("struct Slot16LeafT {")
    b = header.index("using Slot16Leaf =", a)
    return (header[:a].replace(_SLOT_BATCH, _SLOT_BATCH + "\nconstexpr int kSlot16Batch = 2;")
            + header[a:b].replace("kSlotBatch", "kSlot16Batch") + header[b:])


def refill_source(walk: str) -> str:
    start = walk.index(_ANY_BOUNDS)
    body0 = walk.index(") {\n", start) + len(") {\n")
    end = walk.index("  finish_lanes(counter);\n}\n", body0)
    text = walk[:body0] + REFILL_BODY.lstrip("\n") + walk[end:]
    return text.replace("#include <cstdint>\n",
                        "#include <cooperative_groups.h>\n#include <cstdint>\n", 1)


def build_all(src: Path) -> dict:
    """Compile every library of ``variant_sources`` at once; ``{label:
    CDLL}``, each library's ptxas summary printed."""
    out = src / "build"
    out.mkdir(exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for label, source in variant_sources(out).items():
        lib_path = source.parent / f"lib{source.stem}_{label.replace(',', '').replace(' ', '_')}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib_path),
               str(source)]
        jobs[label] = (lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib_path, proc) in jobs.items():
        log = proc.communicate()[0]
        print(f"[ptxas] {label}: {S.ptxas_summary(log)}", flush=True)
        if proc.returncode:
            raise SystemExit(log)
        libs[label] = ctypes.CDLL(str(lib_path))
    print(f"[build] {len(libs)} libraries, nvcc in parallel: {time.perf_counter() - t0:.2f} s "
          "wall", flush=True)
    real = bvh2.build().lib
    for label, lib in libs.items():
        if label.startswith("walk"):
            for name in ("ptrt_bvh2_any", "ptrt_bvh2_skiplink_any_occupancy",
                         "ptrt_bvh2_stack_cap"):
                fn, bound = getattr(lib, name), getattr(real, name)
                fn.argtypes, fn.restype = bound.argtypes, bound.restype
    first_walk = libs["first bvh2_walk"].ptrt_bvh2_any
    first_walk.argtypes = [_P, _I, _P, _P] + [_P] * 6 + [_P, _I, _I, _F, _P] + [_P, _I, _I, _P]
    first_gather = libs["first texture_gather"].ptrt_atlas_gather
    first_gather.argtypes = [_P, _I, _P, _P, _I, _P]
    gathers = [lib.ptrt_atlas_gather for k, lib in libs.items() if k.startswith("gather")]
    for fn in gathers:
        fn.argtypes = [_P, _I, _P, _P, _I, _I, _P]
    floor = libs["floor"]
    floor.ptrt_floor_empty.argtypes = [_I, _P]
    floor.ptrt_floor_copy.argtypes = [_P, _P, _I, _P]
    for fn in (first_walk, first_gather, *gathers, floor.ptrt_floor_empty, floor.ptrt_floor_copy):
        fn.restype = ctypes.c_int
    return libs


def print_builds():
    for name in ("bvh2", "texture_gather"):
        print(f"[ptxas] new {name}: {S.ptxas_summary(build.load(name).log)}", flush=True)


# ---- the skip-link occlusion walk ---------------------------------------------------
def first_any(lib, cs, o, d, limit):
    n = o.x.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.x.device)
    b = cs.bvh
    err = lib.ptrt_bvh2_any(b.tree2.data_ptr(), b.tree2.shape[0] // 8, b.slot_rec.data_ptr(),
                            None, *(x.data_ptr() for x in (*o, *d)), limit.data_ptr(), n, 0,
                            T_MIN, occ.data_ptr(), None, 0, 0, _stream())
    bvh._raise_on("first_any", err)
    return occ


@contextlib.contextmanager
def walk_variant(lib):
    """``bvh2.any_skiplink`` launching ``lib``'s walk, its grid asked of its
    own occupancy entry."""
    saved, resident = bvh2.build, dict(bvh._RESIDENT)
    bvh2.build = lambda: SimpleNamespace(lib=lib)
    bvh._RESIDENT.clear()
    try:
        yield
    finally:
        bvh2.build = saved
        bvh._RESIDENT.clear()
        bvh._RESIDENT.update(resident)


def resident(libs, dev):
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = []
    for label, lib in (("kept", bvh2.build().lib),
                       *((k, v) for k, v in libs.items() if k.startswith("walk"))):
        blocks = ctypes.c_int(0)
        bvh._raise_on(label, lib.ptrt_bvh2_skiplink_any_occupancy(*bvh2.SKIPLINK_PLAN,
                                                                  ctypes.byref(blocks)))
        parts.append(f"{label} {blocks.value} blocks of {bvh.WALK_THREADS} an SM (grid at "
                     f"{S.N_RAYS} lanes {bvh.persistent_grid(S.N_RAYS, n_sms, blocks.value)})")
    print(f"[occupancy] {NEW_ANY}: " + "; ".join(parts) + f"; the first design "
          f"{-(-S.N_RAYS // 128)} blocks of 128", flush=True)


def lanes_of(v: V3, n: int) -> V3:
    """``n`` lanes of ``v``: its lanes repeated from the first past its end."""
    k = torch.arange(n, device=v.x.device) % v.x.shape[0]
    return V3(*(c[k].contiguous() for c in v))


def any_sets(dev):
    """``{label: (cs, o, d, limit)}`` at 131,072 lanes."""
    _scene, cam, cs = S.mesh_scene(dev)
    n = S.N_RAYS
    camera = S.camera_state(cs, cam, n, dev, S.M_WIDTH, S.M_HEIGHT, S.M_DEPTH)
    o, d, _thr, key, depth = camera
    so, sd, lim = S.mesh_shadow(cs, o, d, key, depth)
    lane = torch.arange(n, device=dev)
    spread = torch.where(lane % 7 == 0, -1.0, torch.where(lane % 11 == 0, float("inf"), lim))
    bo, bd, _t, bkey, _bdepth = S.advance_plain(cs, camera, 1)
    ao, ad, _akey, _adepth = S.aimed_rays(cs, bo, bkey)
    sets = {"config 5 shadow rays": (cs, so, sd, lim.contiguous()),
            "config 5 shadow rays, every 11th limit +inf, every 7th -1":
                (cs, so, sd, spread.contiguous()),
            "config 5 secondary rays, per-ray limit": (cs, bo, bd, half_bound(cs, bo, bd, 41)),
            "config 5 aimed rays, limit 1e6":
                (cs, ao, ad, torch.full((n,), 1e6, dtype=torch.float32, device=dev))}
    chain = chain_scene(bvh.STACK_CAP - 2, dev)
    for n_chain in (n, CHAIN_SMALL):
        co, cd = (V3(*(torch.from_numpy(a[:, i].copy()).to(dev) for i in range(3)))
                  for a in chain_rays(chain.bvh.depth2, n_chain, 31))
        ct, _ = tbvh.traverse_closest(chain.bvh, chain.triangles, co, cd, T_MIN, 1e6)
        u = torch.rand(n_chain, generator=torch.Generator(device=dev).manual_seed(32), device=dev)
        sets[f"190-deep chain, {n_chain} rays"] = (chain, co, cd, (ct * (0.5 + u)).contiguous())
    return sets


def check_any(label, lib_first, cs, o, d, limit) -> bool:
    """Bits of the new walk against the first design at each of ``SIZES``
    (the chain's small set at its own size); the lane counter left zero."""
    ok = True
    sizes = SIZES if o.x.shape[0] == S.N_RAYS else (o.x.shape[0],)
    for n in sizes:
        oo, dd = lanes_of(o, n), lanes_of(d, n)
        lim = limit[torch.arange(n, device=limit.device) % limit.shape[0]].contiguous()
        got, want = bvh2.any_skiplink(cs, oo, dd, T_MIN, lim), first_any(lib_first, cs, oo, dd, lim)
        torch.cuda.synchronize()
        eq = S.same_bits(got, want)
        care = lim > 0
        print(f"[bits] skip-link occlusion, {label}, {n} lanes: bit-equal to the first design on "
              f"every lane: {eq} ({int(care.sum())} need an answer, occluded "
              f"{float(got[care].float().mean()):.4f})", flush=True)
        if bvh.lane_counter(torch.device("cuda", 0)).any():
            raise SystemExit("the persistent walk left the lane counter nonzero")
        ok &= eq
    return ok


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


def variant_turns(label, libs, call) -> bool:
    """Device ms per launch of the kept walk and each variant, timed in a
    palindrome; each variant's bits against the kept walk's."""
    walks = {k: v for k, v in libs.items() if k.startswith("walk")}
    order = (None, *walks, *reversed(tuple(walks)), None)
    got = {k: [] for k in (None, *walks)}
    ok = True
    want = call()
    for k in order:
        with walk_variant(walks[k]) if k else contextlib.nullcontext():
            if k and not got[k]:
                ok &= S.same_bits(call(), want)
            got[k].append(device_ms(call, NEW_ANY)[0])
    kept = statistics.mean(got[None])
    print(f"[variant] {label}: kept (no minimum of blocks) {kept:.4f} ms; " + "; ".join(
        f"{k} {statistics.mean(v):.4f} ms ({statistics.mean(v) / kept:.3f}x)"
        for k, v in got.items() if k) + f"; bit-equal {ok}", flush=True)
    return ok


# ---- the texel gather ---------------------------------------------------------------
def first_gather(lib, table, idx):
    n = idx.numel()
    out = torch.empty((3, n), dtype=torch.float32, device=idx.device)
    bvh._raise_on("first_gather", lib.ptrt_atlas_gather(table.data_ptr(), table.shape[0],
                                                        idx.data_ptr(), out.data_ptr(), n,
                                                        _stream()))
    return tuple(out)


def lane_rows(idx: torch.Tensor):
    """A multi-lane gather's output for the int32 indices ``idx``: ``(rows,
    stride)``, three ``(n,)`` float32 rows (r, g, b), views of one buffer
    ``stride`` floats apart (a multiple of 4, at least ``n``), each placed so
    that its lane ``i`` lies at the same offset from a 16-byte boundary as
    ``idx[i]``: the kernel's vector loads of ``idx`` and stores into the
    rows then start at the same lane."""
    n = idx.numel()
    stride = -(-n // 4) * 4
    buf = torch.empty((3 * stride + 3,), dtype=torch.float32, device=idx.device)
    off = (idx.data_ptr() - buf.data_ptr()) % 16 // 4
    return tuple(buf[off + c * stride: off + c * stride + n] for c in range(3)), stride


def variant_gather(lib, table, idx):
    rows, stride = lane_rows(idx)
    bvh._raise_on("variant_gather", lib.ptrt_atlas_gather(
        table.data_ptr(), table.shape[0], idx.data_ptr(), rows[0].data_ptr(), stride,
        idx.numel(), _stream()))
    return rows


def gather_sets(dev):
    """``{label: (table, idx)}`` at 131,072 lanes: the Cornell box's texel
    indices into the atlas and the two mips, and random indices."""
    b = pt.CustomSceneBuilder()
    scene = b.build_scene()
    cs = pt.compile_scene(scene, device=dev)
    blobs = (bounce.pack_scene_blob(cs), bounce.pack_mat_blob(cs), bounce.pack_light_blob(cs))
    o, d, thr, key, depth = S.camera_state(cs, b.create_camera(S.WIDTH / S.HEIGHT), S.N_RAYS, dev)
    rec = bounce.path_bounce(cs, *blobs, o, d, thr, key, depth)
    budget = S.atlas_route_budget(scene)
    cs_b = pt.compile_scene(scene, texture_budget=budget, device=dev)
    cs_m = pt.compile_scene(scene, mip_budget=S.DEFER_MIP, device=dev)
    cs_l = pt.compile_scene(scene, mip_budget=S.LOD_BUDGET, device=dev)
    m = int(cs_b.atlas.shape[0])
    rand = torch.randint(-3, -(-m // 128) * 128 + 200, (S.N_RAYS,), dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(16), device=dev)
    print(f"[gather] atlas route budget {budget}: {m} texels; defer mip "
          f"{cs_m.mip_atlas.shape[0]}, LOD mip {cs_l.mip_atlas.shape[0]} texels; textured lanes "
          f"{int((rec.tex_id >= 0).sum())} of {S.N_RAYS}", flush=True)
    return {"K8, atlas": (cs_b.atlas, texture.texel_index(cs_b, rec.tex_id, rec.u, rec.v)),
            "K9, defer64 mip": (cs_m.mip_atlas,
                                texture.mip_texel_index(cs_m, rec.tex_id, rec.u, rec.v)),
            "K9, LOD mip": (cs_l.mip_atlas,
                            texture.mip_texel_index(cs_l, rec.tex_id, rec.u, rec.v)),
            "random, below 0 and past the atlas": (cs_b.atlas, rand)}


def check_gather(label, libs, table, idx) -> bool:
    """The kept gather, the multi-lane designs and the first design, bit for
    bit, at 131,072 and 131,077 lanes, at 1 and 5, and on ``idx[1:]``."""
    ok = True
    n = idx.numel()
    full = idx[torch.arange(n + 6, device=idx.device) % n].contiguous()
    cases = {f"{n} lanes": full[:n], f"{n + 5} lanes": full[:n + 5], "1 lane": full[:1].clone(),
             "5 lanes": full[:5].clone(), f"idx[1:], {n + 5} lanes": full[1:n + 6]}
    for case, ii in cases.items():
        want = first_gather(libs["first texture_gather"], table, ii)
        got = [tuple(texture.atlas_gather(table, ii)), tuple(texture.gather_plain(table, ii))]
        got += [variant_gather(lib, table, ii) for k, lib in libs.items() if k.startswith("gather")]
        torch.cuda.synchronize()
        eq = all(S.same_bits(a, b) for x in got for a, b in zip(x, want))
        print(f"[bits] gather, {label}, {case} (index at byte {ii.data_ptr() % 16} of 16): kept, "
              f"plain and {len(got) - 2} multi-lane designs bit-equal to the first design: {eq}",
              flush=True)
        ok &= eq
    return ok


def gather_turns(label, libs, table, idx):
    """Device ms per launch of each gather and floor kernel, in a palindrome
    over ``ROUNDS`` rounds: ``{name: [ms, ...]}``."""
    n = idx.numel()
    floor = libs["floor"]
    out = torch.empty((3, n), dtype=torch.float32, device=idx.device)
    calls = {
        "kept (one lane a thread)": (lambda: texture.atlas_gather(table, idx), KEPT_GATHER),
        "first design": (lambda: first_gather(libs["first texture_gather"], table, idx),
                         KEPT_GATHER),
        **{k[len("gather, "):]: (lambda lib=lib: variant_gather(lib, table, idx), LANES_GATHER)
           for k, lib in libs.items() if k.startswith("gather")},
        "empty kernel": (lambda: floor.ptrt_floor_empty(n, _stream()), "floor_empty"),
        "copy kernel": (lambda: floor.ptrt_floor_copy(idx.data_ptr(), out.data_ptr(), n,
                                                      _stream()), "floor_copy"),
    }
    got = {k: [] for k in calls}
    how = set()
    for _ in range(ROUNDS):
        for k in (*calls, *reversed(tuple(calls))):
            ms, method = device_ms(*calls[k])
            got[k].append(ms)
            how.add(method)
    first = got["first design"]
    print(f"[turns] gather, {label} ({'/'.join(sorted(how))}, {2 * ROUNDS} each): " + "; ".join(
        f"{k} {statistics.mean(v) * 1e3:.3f} us ({min(v) * 1e3:.3f}-{max(v) * 1e3:.3f}"
        + (f", {statistics.mean(v) / statistics.mean(first):.3f}x the first, beyond the spread "
           f"{max(v) < min(first)}" if "lanes" in k else "") + ")"
        for k, v in got.items()), flush=True)
    return got


def main(argv) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    S.phase_environment()
    S.phase_build()
    print_builds()
    libs = build_all(Path(argv[0]).resolve())
    dev = torch.device("cuda", 0)
    resident(libs, dev)
    ok, timed = True, {}
    lib_first = libs["first bvh2_walk"]
    for label, (cs, o, d, limit) in any_sets(dev).items():
        ok &= check_any(label, lib_first, cs, o, d, limit)
        new = (lambda cs=cs, o=o, d=d, limit=limit: bvh2.any_skiplink(cs, o, d, T_MIN, limit),
               NEW_ANY)
        first = (lambda cs=cs, o=o, d=d, limit=limit: first_any(lib_first, cs, o, d, limit),
                 FIRST_ANY)
        timed[label] = in_turns(f"skip-link occlusion, {label}", new, first)
        ok &= variant_turns(label, libs, new[0])
        if o.x.shape[0] == S.N_RAYS:  # past the resident lanes, where a refill has lanes to take
            big = (lanes_of(o, SIZES[2]), lanes_of(d, SIZES[2]),
                   limit[torch.arange(SIZES[2], device=dev) % S.N_RAYS].contiguous())
            ok &= variant_turns(f"{label}, {SIZES[2]} lanes", libs,
                                lambda cs=cs, big=big: bvh2.any_skiplink(cs, *big[:2], T_MIN,
                                                                         big[2]))
    gathers = {}
    for label, (table, idx) in gather_sets(dev).items():
        ok &= check_gather(label, libs, table, idx.contiguous())
        gathers[label] = gather_turns(label, libs, table, idx.contiguous())
    print(S.card_line())
    ratios = [a / b for a, b in timed.values()]
    print(f"[summary] skip-link occlusion: {len(ratios)} sets in turns, new / first design "
          f"{min(ratios):.3f}-{max(ratios):.3f}x")
    for design in next(iter(gathers.values())):
        if "lanes" not in design:
            continue
        beats = [max(gathers[k][design]) < min(gathers[k]["first design"]) for k in MAIN_GATHERS]
        print(f"[summary] gather, {design}: " + ", ".join(
            f"{k} {statistics.mean(v[design]) / statistics.mean(v['first design']):.3f}x"
            for k, v in gathers.items())
              + f"; beats the first beyond the spread on every main-path set: {all(beats)}")
    for label, got in gathers.items():
        ms = {k: statistics.mean(v) * 1e3 for k, v in got.items()}
        print(f"[summary] gather floor, {label}: empty {ms['empty kernel']:.3f} us, copy "
              f"{ms['copy kernel']:.3f} us, first design {ms['first design']:.3f} us")
    print(f"[summary] every lane bit-equal to the first designs: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
