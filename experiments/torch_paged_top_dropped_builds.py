#!/usr/bin/env python3
"""Designs of the paged top walks (K6a closest, K6b occlusion) tried beside
the kept one and dropped, on one NVIDIA GPU: each a build of the current
``csrc/bvh_paged.cu`` with one part swapped (``VARIANTS``), held bit for bit
against the kept build on every lane where it should be, and timed against
it in a palindrome (kept, each build, each build in reverse, kept) by device
time per launch, in the default plan (everything staged), on the sets of
``experiments/torch_paged_top_first_design.py`` at 131,072 lanes (bits also
at 131,077):

* ``PtrNodes``: the node records read from the block's copy float by float
  as the tests need them, in place of the kept eight 16-byte loads
  (``Vec4Nodes<true>``); bit-checked;
* ``async staging``: the node and slot copies issued as ``cp.async`` while
  ``stage_records`` runs, and each thread's first ray (K6b: its limit, then
  its ray where needed) read before the block's barrier; bit-checked;
* ``no walk`` and ``no sweep``: the top walk, or the plane/sphere/quad
  sweep, left out, which says how the kernel's time splits; their outputs
  are wrong and not checked.

Each build edits the kept source's text exactly (``_swap``, ``_async_staging``)
and stops with an error where that text has changed: it measures these
designs against the kernel file as it was when they were dropped.

    python3 experiments/torch_paged_top_dropped_builds.py

Builds into ``.scratch/top_dropped`` (all ``nvcc`` at once); prints each
build's registers, the card's name and power limit; exits non-zero when a
bit-checked build differs from the kept one.
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
from path_tracing__ray_tracer_tpu_torch.ops.cuda import build, bvh, bvh_paged  # noqa: E402
from torch_page_walks_first_design import device_ms  # noqa: E402
from torch_paged_top_first_design import (_NEW, RAGGED, bit_equal, ragged, ragged1,  # noqa: E402
                                          scenes)

# The async staging build (see the docstring): its stage_top, its K6a and
# K6b bodies, and the helper that takes the lanes past the first batch.
_ASYNC_STAGE = """// Copy n4 float4s from device memory into shared memory as asynchronous
// 16-byte copies (cp.async); cp_async_wait waits for them.
__device__ __forceinline__ void copy_async16(float4* dst, const float4* __restrict__ src, int n4) {
  for (int k = threadIdx.x; k < n4; k += blockDim.x) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d), "l"(src + k) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\\ncp.async.wait_all;\\n" ::: "memory");
}

template <bool kStage>
__device__ __forceinline__ TopTables<kStage> stage_top(float4* smem4, const float* __restrict__ ps_g,
                                                       const SceneLayout& L, const RecLayout& R,
                                                       const float4* __restrict__ top, int n_top,
                                                       const float4* __restrict__ tslot,
                                                       int n_tslot) {
  if constexpr (kStage) {
    float4* node_copy = smem4 + R.size4;
    const int nq = n_top * (kNode4F / 4);
    float4* slot_copy = node_copy + nq;
    copy_async16(node_copy, top, nq);
    copy_async16(slot_copy, tslot, n_tslot * kSlotF / 4);
    stage_records(reinterpret_cast<float*>(smem4), ps_g, L, R);
    cp_async_wait();
    __syncthreads();
    return TopTables<true>{Vec4Nodes<true>{node_copy},
                           SlotLeaf{reinterpret_cast<const float*>(slot_copy)}};
  } else {
    stage_records(reinterpret_cast<float*>(smem4), ps_g, L, R);
    __syncthreads();
    return TopTables<false>{Vec4Nodes<false>{top},
                            SlotLeaf{reinterpret_cast<const float*>(tslot)}};
  }
}

template <class Work>
__device__ __forceinline__ void later_batches(int* counter, int n, Work&& work) {
  const int span = gridDim.x * blockDim.x;
  if (span >= n) return;
  const int lane = threadIdx.x & 31;
  for (;;) {
    const int i = next_batch(counter, span, n);
    if (i - lane >= n) break;
    if (i < n) work(i);
  }
  finish_lanes(counter);
}
"""
_ASYNC_K6A = """  extern __shared__ float4 smem4[];
  const SceneLayout L = scene_layout(P, S, Q, 0);
  const RecLayout R = rec_layout(P, S, Q, 0);
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r0{};
  if (first < n) r0 = load_ray(ox, oy, oz, dx, dy, dz, first);
  const TopTables<kStage> tab =
      stage_top<kStage>(smem4, ps_g, L, R, reinterpret_cast<const float4*>(top), n_top,
                        reinterpret_cast<const float4*>(tslot), n_tslot);
  const int off = P + S + Q;
  const auto lane_walk = [&](int i, const Ray& r) {
    Hit h = closest_hit16(smem4, R, r, t_min, t_max);
    Pend pend{0u, 0u};
    LocalStack<stack_cap(kDepth)> stack;
    walk_closest_with<true>(tab.nodes, n_top, tab.leaf, stack, r, t_min, off, h, &pend);
    finish_hit(h, r, off, gid_mask);
    store_hit(h, i, t_out, prim_out, u_out, v_out, nx_out, ny_out, nz_out);
    plo_out[i] = (int)pend.lo;
    phi_out[i] = (int)pend.hi;
  };
  if (first < n) lane_walk(first, r0);
  later_batches(counter, n, [&](int i) { lane_walk(i, load_ray(ox, oy, oz, dx, dy, dz, i)); });
}"""
_ASYNC_K6B = """  extern __shared__ float4 smem4[];
  const SceneLayout L = scene_layout(P, S, Q, 0);
  const RecLayout R = rec_layout(P, S, Q, 0);
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const float limit0 = first < n ? limit_in[first] : 0.0f;
  Ray r0{};
  if (!(limit0 <= 0.0f)) r0 = load_ray(ox, oy, oz, dx, dy, dz, first);
  const TopTables<kStage> tab =
      stage_top<kStage>(smem4, ps_g, L, R, reinterpret_cast<const float4*>(top), n_top,
                        reinterpret_cast<const float4*>(tslot), n_tslot);
  const auto lane_walk = [&](int i, float limit, const Ray& r) {
    bool found = limit <= 0.0f;
    Pend pend{0u, 0u};
    if (!found) {
      found = any_hit16(smem4, R, r, t_min, limit);
      if (!found) {
        LocalStack<stack_cap(kDepth)> stack;
        found = walk_any_with<true>(tab.nodes, n_top, tab.leaf, stack, r, t_min, limit, &pend);
      }
    }
    found_out[i] = found ? 1 : 0;
    plo_out[i] = (int)pend.lo;
    phi_out[i] = (int)pend.hi;
  };
  if (first < n) lane_walk(first, limit0, r0);
  later_batches(counter, n, [&](int i) {
    const float limit = limit_in[i];
    Ray r{};
    if (!(limit <= 0.0f)) r = load_ray(ox, oy, oz, dx, dy, dz, i);
    lane_walk(i, limit, r);
  });
}"""


def _async_staging(text: str) -> str:
    """The kept source with stage_top and the two kernels' bodies replaced."""
    a = text.index("template <bool kStage>\n__device__ __forceinline__ TopTables<kStage> stage_top(")
    b = text.index("// The bytes of a top walk block's tables")
    text = text[:a] + _ASYNC_STAGE + "\n" + text[b:]
    body_end = "  if (span < n) finish_lanes(counter);\n}"
    for new in (_ASYNC_K6A, _ASYNC_K6B):
        a = text.index("  extern __shared__ float4 smem4[];\n  const SceneLayout L")
        b = text.index(body_end, a) + len(body_end)
        text = text[:a] + new.replace("extern __shared__", "extern  __shared__", 1) + text[b:]
    return text.replace("extern  __shared__", "extern __shared__")


def _swap(*pairs):
    def edit(text: str) -> str:
        for old, new in pairs:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        return text
    return edit


# The node source of the PtrNodes build (the port's headers no longer carry
# it): a record's floats read one by one through a pointer.
_PTR_NODES = """struct PtrNodes {
  const float* __restrict__ nodes;

  __device__ __forceinline__ const float* rec(int node, float (&)[kNode4F]) const {
    return nodes + (size_t)node * kNode4F;
  }
};

"""

# name -> (the source edit, whether its outputs are the first design's)
VARIANTS = {
    "PtrNodes": (_swap(("namespace ptrt {\n", "namespace ptrt {\n\n" + _PTR_NODES),
                       ("struct TopTables {\n  Vec4Nodes<kStage> nodes;",
                        "struct TopTables {\n  std::conditional_t<kStage, PtrNodes, "
                        "Vec4Nodes<false>> nodes;"),
                       ("Vec4Nodes<true>{node_copy}",
                        "PtrNodes{reinterpret_cast<const float*>(node_copy)}"),
                       ("#include <cstdint>\n", "#include <cstdint>\n#include <type_traits>\n")),
                 True),
    "async staging": (_async_staging, True),
    "no walk": (_swap(
        ("    walk_closest_with<true>(tab.nodes, n_top, tab.leaf, stack, r, t_min, off, h, &pend);\n",
         ""),
        ("        found = walk_any_with<true>(tab.nodes, n_top, tab.leaf, stack, r, t_min, limit, "
         "&pend);\n", "")), False),
    "no sweep": (_swap(("    Hit h = closest_hit16(smem4, R, r, t_min, t_max);\n",
                        "    Hit h{t_max, -1, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};\n"),
                       ("      found = any_hit16(smem4, R, r, t_min, limit);\n",
                        "      found = false;\n")), False),
}


def _nvcc(out: Path, name: str, source: Path):
    lib_path = out / f"lib{name}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib_path),
           str(source)]
    return lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)


def build_libs(out: Path):
    """The current ``bvh_paged.cu`` edited as each of ``VARIANTS`` says, one
    ``nvcc`` each, all at once; ``{variant name: lib}`` with the kept
    library's argument types."""
    out.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "bvh_paged.cu").read_text()
    jobs = {}
    t0 = time.perf_counter()
    for name, (edit, _checked) in VARIANTS.items():
        tag = name.replace(" ", "_")
        src = out / f"bvh_paged_{tag}.cu"
        src.write_text(edit(text))
        jobs[name] = _nvcc(out, f"variant_paged_{tag}", src)
    real = bvh_paged.build().lib
    libs = {}
    for name, (lib_path, proc) in jobs.items():
        log = proc.communicate()[0]
        print(f"[{name}] " + "; ".join(x for x in S.ptxas_summary(log).split("; ")
                                       if "top" in x or "rror" in x), flush=True)
        if proc.returncode:
            raise SystemExit(log)
        lib = ctypes.CDLL(str(lib_path))
        for entry in ("ptrt_paged_top_closest", "ptrt_paged_top_any",
                      "ptrt_paged_top_closest_occupancy", "ptrt_paged_top_any_occupancy"):
            fn, bound = getattr(lib, entry), getattr(real, entry)
            fn.argtypes, fn.restype = bound.argtypes, bound.restype
        libs[name] = lib
    print(f"[build] nvcc in parallel: {time.perf_counter() - t0:.2f} s wall", flush=True)
    return libs


@contextlib.contextmanager
def variant(lib):
    """The wrappers launching ``lib``'s top walks, their grids asked of its
    own occupancy entries."""
    saved, resident = bvh_paged.build, dict(bvh._RESIDENT)
    bvh_paged.build = lambda: SimpleNamespace(lib=lib)
    bvh._RESIDENT.clear()
    try:
        yield
    finally:
        bvh_paged.build = saved
        bvh._RESIDENT.clear()
        bvh._RESIDENT.update(resident)


def main() -> int:
    S.phase_environment()
    S.phase_build()
    print("[build] kept bvh_paged: " + "; ".join(
        x for x in S.ptxas_summary(build.load("bvh_paged").log).split("; ") if "top" in x),
          flush=True)
    libs = build_libs(ROOT / ".scratch" / "top_dropped")
    dev = torch.device("cuda", 0)
    names = list(VARIANTS)
    checked = [k for k in names if VARIANTS[k][1]]
    ok, ratios = True, {k: {name: [] for name in names} for k in ("K6a", "K6b")}
    for label, cs, sets in scenes(dev):
        for name, (o, d, so, sd, lim) in sets.items():
            for n in (S.N_RAYS, RAGGED):
                oo, dd, sso, ssd, ll = (ragged(o, n), ragged(d, n), ragged(so, n),
                                        ragged(sd, n), ragged1(lim, n))
                key = f"{label} {name}, {n} lanes"
                calls = {"K6a": lambda: bvh_paged.paged_top_closest(cs, oo, dd, 1e-3, 1e6),
                         "K6b": lambda: bvh_paged.paged_top_any(cs, sso, ssd, 1e-3, ll)}
                for kernel, call in calls.items():
                    want = call()
                    for k in checked:
                        with variant(libs[k]):
                            ok &= bit_equal(f"{kernel} {key} {k}", call(), want)
                    if n != S.N_RAYS:
                        continue
                    runs = {k: [] for k in ["kept", *names]}
                    for k in ["kept", *names, *reversed(names), "kept"]:
                        with variant(libs[k]) if k != "kept" else contextlib.nullcontext():
                            runs[k].append(device_ms(call, _NEW[kernel])[0])
                    kept = statistics.mean(runs["kept"])
                    for k in names:
                        ratios[kernel][k].append(statistics.mean(runs[k]) / kept)
                    print(f"[turns] {kernel} {key}: kept build {kept:.4f} ms; " + "; ".join(
                        f"{k} {statistics.mean(runs[k]):.4f} ms -> "
                        f"{statistics.mean(runs[k]) / kept:.3f}x" for k in names), flush=True)
        torch.cuda.synchronize()
        if bvh.lane_counter(dev).any():
            raise SystemExit("the top walks left the lane counter nonzero")
        del cs, sets
        torch.cuda.empty_cache()
    print(S.card_line())
    for kernel, by in ratios.items():
        for k, r in by.items():
            print(f"[summary] {kernel} {k} / kept build: {min(r):.3f}-{max(r):.3f}x "
                  f"over {len(r)} sets")
    print(f"[summary] the bit-checked builds ({', '.join(checked)}) bit-equal to the kept one: "
          f"{ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
