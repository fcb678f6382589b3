// The two-level (paged) BVH walk, one ray per thread: the top walk (K6a
// closest, K6b occlusion) and the walk of each lane's pending pages (K6c
// closest, K6d occlusion).  Over the whole one-level tree as a single page
// with every lane on, K6c and K6d are the triangle-only BVH4 walks (K4c,
// K4d), the carried best seeded with a per-ray bound.
//
// Replaces the JAX package's ops/pallas/bvh_paged_pallas.py::
// _paged_top_closest_kernel, _paged_top_any_kernel, _page_closest_kernel and
// _page_any_kernel (entered there through bvh_paged_scene_closest_pallas and
// bvh_paged_scene_any_pallas), and ops/pallas/bvh_pallas.py::
// _bvh4_closest_attrs_kernel, _bvh4_closest_kernel and _bvh4_any_kernel (the
// same _bvh4_walk / _bvh4_any_walk bodies over the whole tree).
//
// On the TPU the tree must sit in SMEM, so a big one is cut into pages of at
// most ~200K floats; the top kernel emits per-lane pending-page masks and the
// wrapper launches one rooted walk per page (after a coherence sort, a
// root-box cull and a skip of pages no lane needs).  Here every page sits in
// device memory and each thread walks its own ray, so one launch walks all of
// a lane's pending pages in increasing index: 2 launches per query instead of
// 1 + n_pages, and no host decision per page.  Kept exactly, per lane: the
// slab and Möller–Trumbore tests of bvh_walk.cuh, strict `<` against the
// carried best, pages in increasing index, and the cull of _page_root_slab
// (the page root's box against the carried best) before each page.  So a
// lane's winner equals the composition of the JAX per-page launches.
//
// What bounds them: latency, as K4a (dependent node and slot loads, one ray
// per thread).  Per ray K6a reads 24 B and writes 36 B, K6c reads 60 B and
// writes 28 B, K6b reads 28 B and writes 9 B, K6d reads 29 B and writes 1 B,
// against walks of tens of 128 B node records and 64 B slot records.
//
// The top walks (K6a, K6b) are designed for Hopper as K1 and K7 are
// (path_bounce.cu, path_step.cu): persistent blocks of 256 threads, as many as
// are resident, each warp taking its first 32 lanes by its place in the grid
// and later ones from the stream's lane counter (next_batch; a grid that
// spans all lanes touches no counter).  Each resident block stages its tables
// once (the first design, a block of 128 lanes each, copied the field-major
// blob 1,024 times at 131,072 lanes): the planes, spheres and quads as
// primitive-major 16-byte records (stage_records; swept by closest_hit16 /
// any_hit16), then, in the staged variant, the top tree's node records and
// the 13-float top slots, read from there by Vec4Nodes<true> and SlotLeaf;
// the other variant reads the same records from device memory (the nodes as
// 16-byte loads, Vec4Nodes, the slots float by float, SlotLeaf).
// ops/cuda/bvh_paged.top_plan picks the variant from sizes (the tables staged
// whenever they fit the block's shared memory beside the primitive records:
// a top tree has at most 64 page children but its leaves are unbounded) and
// the stack's depth class from the top tree's depth (22 entries for config 6
// and the 512K scene, where the first design carried 96).  K6b loads a lane's
// ray only where the lane's limit is positive.  Each lane's floats and its
// order of tests are the first design's (git 86bcdb5), so its record, found
// flag and pending words are too.  On config 6 the walk takes 34-49% of the
// time and the sweep 18-26% (builds without either), so the redesign gains
// most where top leaves hold triangles.  There staging gains too (0.81-0.96x
// the device-memory variant's time on the 48-page scene); on config 6, with
// no top leaf, it gains nothing for K6a (0.99-1.01x) and costs K6b 4-6%
// (PERF.md).  Issuing the node and slot copies as cp.async while
// stage_records runs, with each thread's first ray read before the block's
// barrier, measured 1.04-1.08x this design's time on config 6 on an H100
// and was dropped (experiments/torch_paged_top_dropped_builds.py).
//
// The page walks (K6c, K6d; so K4c, K4d) are designed for Hopper as K4b is
// (bvh_scene.cu): persistent blocks of 256 threads, as many as are resident,
// whose warps take 32 lanes at a time from a counter (next_lane), since a
// lane's work varies widely (from none to several of config 6's 14 pages,
// each after a root-box cull) and a block of fixed lanes waits on its
// slowest one; node records read as eight 16-byte loads (Vec4Nodes) and
// leaves from the padded 64 B slot copy, four slots' loads issued together
// (Slot16Leaf); a stack of 3 * depth class - 2 entries in local memory, the
// class from the page depth (K6c/K6d) or the whole tree's (K4c/K4d).
// Nothing is staged in shared memory: a config-6 page holds ~800 KB, past a
// block's 227 KB, while all 14 pages (0.6 MB of node records, 12.9 MB of
// padded slot records) fit the 50 MB L2.  Each lane's floats and its order
// of tests are the first design's, so its results are too.
//
// Records: the top tree as bvh_walk.cuh's, page children marked by their
// metas; page p's BVH4 records at page_tree + p * tc, its
// padded slot records at page_slot16 + p * sc16 (ops/bvh.py
// pack_page_slot16); its root box at page_lo/page_hi + 3p.  Closest records
// (t, prim, u, v, normal) are finished (finish_hit): decoded prim, triangle
// normals flipped toward the ray, raw barycentrics as u, v.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "sweep.cuh"

namespace ptrt {

// The lane's next pending page (lowest index first), cleared from `pend`;
// -1 when none is left.
__device__ __forceinline__ int next_page(Pend& pend) {
  if (pend.lo) {
    const int p = __ffs(pend.lo) - 1;
    pend.lo &= pend.lo - 1;
    return p;
  }
  if (pend.hi) {
    const int p = __ffs(pend.hi) - 1;
    pend.hi &= pend.hi - 1;
    return 32 + p;
  }
  return -1;
}

// _page_root_slab: does the lane enter page p's root box below `far`?
__device__ __forceinline__ bool page_root_slab(const float* __restrict__ page_lo,
                                               const float* __restrict__ page_hi, int p,
                                               const WalkRay& w, float t_min, float far) {
  const float b[6] = {page_lo[3 * p], page_lo[3 * p + 1], page_lo[3 * p + 2],
                      page_hi[3 * p], page_hi[3 * p + 1], page_hi[3 * p + 2]};
  return slab(b, w, t_min, far);
}

__device__ __forceinline__ Pend load_pend(const int* __restrict__ plo, const int* __restrict__ phi,
                                          int i) {
  // no masks: the whole tree is page 0 and every lane walks it
  Pend p;
  p.lo = plo ? (unsigned)plo[i] : 1u;
  p.hi = phi ? (unsigned)phi[i] : 0u;
  return p;
}

__device__ __forceinline__ void store_hit(const Hit& h, int i, float* __restrict__ t,
                                          int* __restrict__ prim, float* __restrict__ u,
                                          float* __restrict__ v, float* __restrict__ nx,
                                          float* __restrict__ ny, float* __restrict__ nz) {
  t[i] = h.t;
  prim[i] = h.prim;
  u[i] = h.u;
  v[i] = h.v;
  nx[i] = h.nx;
  ny[i] = h.ny;
  nz[i] = h.nz;
}

// A top walk block's tables in shared memory: the plane/sphere/quad records,
// then (kStage) the top tree's node records and the 13-float top slots,
// copied by the whole block as 16-byte loads and stores.  The staged variant
// reads a node record from that copy as eight 16-byte loads (Vec4Nodes<true>)
// and a slot's floats as its test needs them (SlotLeaf): 64 registers at
// most, so four blocks of 256 stay resident, 1,024 lanes an SM, and 131,072
// lanes take one wave; the other variant, reading the same records from
// device memory, takes 64 and 56 registers and keeps four blocks too.
// (Reading the staged node's floats one by one, PtrNodes, took 1.00-1.01x
// this one's time on config 6 on an H100 and 1.06-1.07x on the 48-page
// scene; slots padded to 16 floats and read four at a time, as Slot16Leaf
// reads them, needed a padded copy and more registers, PERF.md.)
template <bool kStage>
struct TopTables {
  Vec4Nodes<kStage> nodes;
  SlotLeaf leaf;
};

template <bool kStage>
__device__ __forceinline__ TopTables<kStage> stage_top(float4* smem4, const float* __restrict__ ps_g,
                                                       const SceneLayout& L, const RecLayout& R,
                                                       const float4* __restrict__ top, int n_top,
                                                       const float4* __restrict__ tslot,
                                                       int n_tslot) {
  stage_records(reinterpret_cast<float*>(smem4), ps_g, L, R);
  if constexpr (kStage) {
    float4* node_copy = smem4 + R.size4;
    const int nq = n_top * (kNode4F / 4);
    for (int k = threadIdx.x; k < nq; k += blockDim.x) node_copy[k] = __ldg(top + k);
    float4* slot_copy = node_copy + nq;
    const int sq = n_tslot * kSlotF / 4;  // whole leaves of 16 slots: 52 float4s each
    for (int k = threadIdx.x; k < sq; k += blockDim.x) slot_copy[k] = __ldg(tslot + k);
    __syncthreads();
    return TopTables<true>{Vec4Nodes<true>{node_copy},
                           SlotLeaf{reinterpret_cast<const float*>(slot_copy)}};
  } else {
    __syncthreads();
    return TopTables<false>{Vec4Nodes<false>{top},
                            SlotLeaf{reinterpret_cast<const float*>(tslot)}};
  }
}

// The bytes of a top walk block's tables (ops/cuda/bvh_paged.top_plan).
__host__ __device__ inline size_t top_smem_bytes(int P, int S, int Q, int stage, int n_top,
                                                 int n_tslot) {
  const size_t rec = sizeof(float4) * (size_t)rec_layout(P, S, Q, 0).size4;
  return rec + (stage ? sizeof(float) * ((size_t)n_top * kNode4F + (size_t)n_tslot * kSlotF) : 0);
}

// K6a for Hopper: the plane/sphere/quad sweep seeds the walk of the top tree,
// for lanes [0, n); `counter`: two int32, zero at the launch and left zero.
template <int kDepth, bool kStage>
__global__ void __launch_bounds__(kWalkThreads)
paged_top_closest_persistent(const float* __restrict__ top, int n_top,
                             const float* __restrict__ tslot, int n_tslot,
                             const float* __restrict__ ps_g, int P, int S, int Q,
                             const float* __restrict__ ox, const float* __restrict__ oy,
                             const float* __restrict__ oz, const float* __restrict__ dx,
                             const float* __restrict__ dy, const float* __restrict__ dz, int n,
                             int gid_mask, float t_min, float t_max, float* __restrict__ t_out,
                             int* __restrict__ prim_out, float* __restrict__ u_out,
                             float* __restrict__ v_out, float* __restrict__ nx_out,
                             float* __restrict__ ny_out, float* __restrict__ nz_out,
                             int* __restrict__ plo_out, int* __restrict__ phi_out,
                             int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  const SceneLayout L = scene_layout(P, S, Q, 0);
  const RecLayout R = rec_layout(P, S, Q, 0);
  const TopTables<kStage> tab =
      stage_top<kStage>(smem4, ps_g, L, R, reinterpret_cast<const float4*>(top), n_top,
                        reinterpret_cast<const float4*>(tslot), n_tslot);
  const int off = P + S + Q;
  const int lane = threadIdx.x & 31;
  const int span = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;; i = next_batch(counter, span, n)) {
    if (i - lane >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
    Hit h = closest_hit16(smem4, R, r, t_min, t_max);
    Pend pend{0u, 0u};
    LocalStack<stack_cap(kDepth)> stack;
    walk_closest_with<true>(tab.nodes, n_top, tab.leaf, stack, r, t_min, off, h, &pend);
    finish_hit(h, r, off, gid_mask);
    store_hit(h, i, t_out, prim_out, u_out, v_out, nx_out, ny_out, nz_out);
    plo_out[i] = (int)pend.lo;
    phi_out[i] = (int)pend.hi;
  }
  if (span < n) finish_lanes(counter);
}

// K6b for Hopper: occlusion in (t_min, limit) by the planes/spheres/quads,
// then the top tree, for lanes [0, n) taken as K6a takes them.  Found lanes
// pend no page (the bits a walk set before its hit stay set); a lane with
// limit <= 0, whose answer is not needed, is written found with no page and
// reads no ray.
template <int kDepth, bool kStage>
__global__ void __launch_bounds__(kWalkThreads)
paged_top_any_persistent(const float* __restrict__ top, int n_top,
                         const float* __restrict__ tslot, int n_tslot,
                         const float* __restrict__ ps_g, int P, int S, int Q,
                         const float* __restrict__ ox, const float* __restrict__ oy,
                         const float* __restrict__ oz, const float* __restrict__ dx,
                         const float* __restrict__ dy, const float* __restrict__ dz,
                         const float* __restrict__ limit_in, int n, float t_min,
                         uint8_t* __restrict__ found_out, int* __restrict__ plo_out,
                         int* __restrict__ phi_out, int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  const SceneLayout L = scene_layout(P, S, Q, 0);
  const RecLayout R = rec_layout(P, S, Q, 0);
  const TopTables<kStage> tab =
      stage_top<kStage>(smem4, ps_g, L, R, reinterpret_cast<const float4*>(top), n_top,
                        reinterpret_cast<const float4*>(tslot), n_tslot);
  const int lane = threadIdx.x & 31;
  const int span = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;; i = next_batch(counter, span, n)) {
    if (i - lane >= n) break;
    if (i >= n) continue;
    const float limit = limit_in[i];
    bool found = limit <= 0.0f;
    Pend pend{0u, 0u};
    if (!found) {
      const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
      found = any_hit16(smem4, R, r, t_min, limit);
      if (!found) {
        LocalStack<stack_cap(kDepth)> stack;
        found = walk_any_with<true>(tab.nodes, n_top, tab.leaf, stack, r, t_min, limit, &pend);
      }
    }
    found_out[i] = found ? 1 : 0;
    plo_out[i] = (int)pend.lo;
    phi_out[i] = (int)pend.hi;
  }
  if (span < n) finish_lanes(counter);
}

using TopClosestKernel = decltype(&paged_top_closest_persistent<kMaxDepth4, false>);
using TopAnyKernel = decltype(&paged_top_any_persistent<kMaxDepth4, false>);

// The top walks' variants (ops/cuda/bvh_paged.top_plan): staged or not, one
// per depth class; nullptr for any other stage or class.
template <int kDepth>
inline TopClosestKernel top_closest_of(int stage) {
  if (stage == 1) return &paged_top_closest_persistent<kDepth, true>;
  if (stage == 0) return &paged_top_closest_persistent<kDepth, false>;
  return nullptr;
}

inline TopClosestKernel top_closest_variant(int stage, int depth_class) {
  if (depth_class == kShallow4) return top_closest_of<kShallow4>(stage);
  if (depth_class == kMaxDepth4) return top_closest_of<kMaxDepth4>(stage);
  return nullptr;
}

template <int kDepth>
inline TopAnyKernel top_any_of(int stage) {
  if (stage == 1) return &paged_top_any_persistent<kDepth, true>;
  if (stage == 0) return &paged_top_any_persistent<kDepth, false>;
  return nullptr;
}

inline TopAnyKernel top_any_variant(int stage, int depth_class) {
  if (depth_class == kShallow4) return top_any_of<kShallow4>(stage);
  if (depth_class == kMaxDepth4) return top_any_of<kMaxDepth4>(stage);
  return nullptr;
}

// Resident blocks per SM of a top walk variant with `smem` bytes of dynamic
// shared memory, into *blocks; first lifts the kernel's limit to `smem`.
template <class K>
inline int top_occupancy(K kernel, int smem, int* blocks) {
  if (kernel == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kWalkThreads, smem);
  return (int)err;
}

// The node records of page p, read as 16-byte loads (tc is a multiple of 32
// floats, so each page starts on a 128 B boundary of a 16-byte aligned base).
__device__ __forceinline__ Vec4Nodes<false> page_nodes(const float* __restrict__ page_tree,
                                                       long long tc, int p) {
  return Vec4Nodes<false>{reinterpret_cast<const float4*>(page_tree + (size_t)p * tc)};
}

// The padded slot records of page p (sc16 floats a page, 16 a slot).
__device__ __forceinline__ Slot16Leaf page_leaf(const float* __restrict__ page_slot16,
                                                long long sc16, int p) {
  return Slot16Leaf{reinterpret_cast<const float4*>(page_slot16 + (size_t)p * sc16)};
}

// visit(p) for each of the lane's pending pages below n_pages, lowest index
// first, until a visit returns true.  Stepping a warp through the union of
// its lanes' pages together, so that its lanes read one page at a time, gives
// the same results but took 1.23-1.44x this order's time on config 6 on an
// H100 (PERF.md): the lanes idle through the pages that are not theirs.
template <class Visit>
__device__ __forceinline__ void visit_pages(Pend pend, int n_pages, Visit&& visit) {
  for (int p = next_page(pend); p >= 0 && p < n_pages; p = next_page(pend))
    if (visit(p)) break;
}

// K6c (K4c) for Hopper: the carried closest record of lanes [0, n) through
// each of the lane's pending pages, the lanes taken 32 at a time from
// `counter` (two int32, zero at the launch, left zero; finish_lanes).
template <int kDepth>
__global__ void __launch_bounds__(kWalkThreads, 2)
pages_closest_persistent(const float* __restrict__ page_tree, long long tc,
                         const float* __restrict__ page_slot16, long long sc16,
                         const float* __restrict__ page_lo, const float* __restrict__ page_hi,
                         int n_pages, int gid_offset, int gid_mask, const float* __restrict__ ox,
                         const float* __restrict__ oy, const float* __restrict__ oz,
                         const float* __restrict__ dx, const float* __restrict__ dy,
                         const float* __restrict__ dz, const int* __restrict__ plo,
                         const int* __restrict__ phi, const float* __restrict__ t_in,
                         const int* __restrict__ prim_in, const float* __restrict__ u_in,
                         const float* __restrict__ v_in, const float* __restrict__ nx_in,
                         const float* __restrict__ ny_in, const float* __restrict__ nz_in, int n,
                         float t_min, float* __restrict__ t_out, int* __restrict__ prim_out,
                         float* __restrict__ u_out, float* __restrict__ v_out,
                         float* __restrict__ nx_out, float* __restrict__ ny_out,
                         float* __restrict__ nz_out, int* __restrict__ counter) {
  const int n_page_nodes = (int)(tc / kNode4F);
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
    const WalkRay w = walk_ray(r);
    Hit h;
    h.t = t_in[i]; h.prim = prim_in[i]; h.u = u_in[i]; h.v = v_in[i];
    h.nx = nx_in[i]; h.ny = ny_in[i]; h.nz = nz_in[i];
    visit_pages(load_pend(plo, phi, i), n_pages, [&](int p) {
      if (!page_root_slab(page_lo, page_hi, p, w, t_min, h.t)) return false;  // PAGE_CULL
      LocalStack<stack_cap(kDepth)> stack;
      walk_closest_with<false>(page_nodes(page_tree, tc, p), n_page_nodes,
                               page_leaf(page_slot16, sc16, p), stack, r, t_min, gid_offset, h,
                               nullptr);
      return false;
    });
    finish_hit(h, r, gid_offset, gid_mask);
    store_hit(h, i, t_out, prim_out, u_out, v_out, nx_out, ny_out, nz_out);
  }
  finish_lanes(counter);
}

// K6d (K4d) for Hopper: the carried occlusion verdict of lanes [0, n) through
// each pending page, up to the first hit; lanes as K6c takes them.
template <int kDepth>
__global__ void __launch_bounds__(kWalkThreads, 2)
pages_any_persistent(const float* __restrict__ page_tree, long long tc,
                     const float* __restrict__ page_slot16, long long sc16, int n_pages,
                     const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const int* __restrict__ plo, const int* __restrict__ phi,
                     const float* __restrict__ limit_in, const uint8_t* __restrict__ found_in,
                     int n, float t_min, uint8_t* __restrict__ found_out,
                     int* __restrict__ counter) {
  const int n_page_nodes = (int)(tc / kNode4F);
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;
    if (i >= n) continue;
    bool found = found_in[i] != 0;
    if (!found) {
      const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
      const float limit = limit_in[i];
      visit_pages(load_pend(plo, phi, i), n_pages, [&](int p) {
        LocalStack<stack_cap(kDepth)> stack;
        found = walk_any_with<false>(page_nodes(page_tree, tc, p), n_page_nodes,
                                     page_leaf(page_slot16, sc16, p), stack, r, t_min, limit,
                                     nullptr);
        return found;
      });
    }
    found_out[i] = found ? 1 : 0;
  }
  finish_lanes(counter);
}

using ClosestKernel = decltype(&pages_closest_persistent<kMaxDepth4>);
using AnyKernel = decltype(&pages_any_persistent<kMaxDepth4>);

// The variants the wrappers pick among (ops/cuda/bvh.page_plan): one per
// depth class; nullptr for any other class.
inline ClosestKernel closest_variant(int depth_class) {
  if (depth_class == kShallow4) return pages_closest_persistent<kShallow4>;
  if (depth_class == kMaxDepth4) return pages_closest_persistent<kMaxDepth4>;
  return nullptr;
}

inline AnyKernel any_variant(int depth_class) {
  if (depth_class == kShallow4) return pages_any_persistent<kShallow4>;
  if (depth_class == kMaxDepth4) return pages_any_persistent<kMaxDepth4>;
  return nullptr;
}

}  // namespace ptrt

// All four launch on `stream`, allocate nothing and do not synchronise.  Each
// returns the launch's cudaError_t (0 when the launch was accepted).  plo and
// phi may be null in the page walks: then every lane walks page 0 alone.
// A launch on no lanes launches nothing.

// K6a: `grid` persistent blocks of the variant for (stage, depth_class),
// with `smem` bytes of dynamic shared memory (top_smem_bytes), which
// ptrt_paged_top_closest_occupancy has sized and allowed; `counter` is two
// int32 of scratch, zero at the launch and left zero by the kernel.  tslot
// holds n_tslot top slots of 13 floats, n_tslot a multiple of 16; top and
// tslot are 16-byte aligned.
extern "C" int ptrt_paged_top_closest(const float* top, int n_top, const float* tslot,
                                      int n_tslot, const float* ps, int P, int S, int Q,
                                      const float* ox, const float* oy, const float* oz,
                                      const float* dx, const float* dy, const float* dz, int n,
                                      int gid_mask, float t_min, float t_max, float* t, int* prim,
                                      float* u, float* v, float* nx, float* ny, float* nz,
                                      int* plo, int* phi, int* counter, int stage,
                                      int depth_class, int smem, int grid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::TopClosestKernel k = ptrt::top_closest_variant(stage, depth_class);
  if (k == nullptr || (size_t)smem < ptrt::top_smem_bytes(P, S, Q, stage, n_top, n_tslot))
    return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, smem, (cudaStream_t)stream>>>(
      top, n_top, tslot, n_tslot, ps, P, S, Q, ox, oy, oz, dx, dy, dz, n, gid_mask,
      t_min, t_max, t, prim, u, v, nx, ny, nz, plo, phi, counter);
  return (int)cudaGetLastError();
}

extern "C" int ptrt_paged_top_closest_occupancy(int stage, int depth_class, int smem,
                                                int* blocks) {
  return ptrt::top_occupancy(ptrt::top_closest_variant(stage, depth_class), smem, blocks);
}

// K6b: as ptrt_paged_top_closest.
extern "C" int ptrt_paged_top_any(const float* top, int n_top, const float* tslot,
                                  int n_tslot, const float* ps, int P, int S, int Q,
                                  const float* ox,
                                  const float* oy, const float* oz, const float* dx,
                                  const float* dy, const float* dz, const float* limit, int n,
                                  float t_min, uint8_t* found, int* plo, int* phi, int* counter,
                                  int stage, int depth_class, int smem, int grid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::TopAnyKernel k = ptrt::top_any_variant(stage, depth_class);
  if (k == nullptr || (size_t)smem < ptrt::top_smem_bytes(P, S, Q, stage, n_top, n_tslot))
    return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, smem, (cudaStream_t)stream>>>(
      top, n_top, tslot, n_tslot, ps, P, S, Q, ox, oy, oz, dx, dy, dz, limit, n, t_min,
      found, plo, phi, counter);
  return (int)cudaGetLastError();
}

extern "C" int ptrt_paged_top_any_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::top_occupancy(ptrt::top_any_variant(stage, depth_class), smem, blocks);
}

// K6c (K4c): `grid` persistent blocks of the variant for depth_class, which
// ptrt_pages_closest_occupancy has sized; `counter` is two int32 of scratch,
// zero at the launch and left zero by the kernel.  page_slot16 holds sc16
// floats a page (16 a slot), page_tree tc floats a page, both 16-byte aligned.
extern "C" int ptrt_pages_closest(const float* page_tree, long long tc, const float* page_slot16,
                                  long long sc16, const float* page_lo, const float* page_hi,
                                  int n_pages, int gid_offset, int gid_mask, const float* ox,
                                  const float* oy, const float* oz, const float* dx,
                                  const float* dy, const float* dz, const int* plo,
                                  const int* phi, const float* t_in, const int* prim_in,
                                  const float* u_in, const float* v_in, const float* nx_in,
                                  const float* ny_in, const float* nz_in, int n, float t_min,
                                  float* t, int* prim, float* u, float* v, float* nx, float* ny,
                                  float* nz, int* counter, int depth_class, int grid,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::ClosestKernel k = ptrt::closest_variant(depth_class);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, 0, (cudaStream_t)stream>>>(
      page_tree, tc, page_slot16, sc16, page_lo, page_hi, n_pages, gid_offset, gid_mask, ox, oy,
      oz, dx, dy, dz, plo, phi, t_in, prim_in, u_in, v_in, nx_in, ny_in, nz_in, n, t_min, t, prim,
      u, v, nx, ny, nz, counter);
  return (int)cudaGetLastError();
}

extern "C" int ptrt_pages_closest_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::walk_occupancy(ptrt::closest_variant(depth_class), stage, smem, blocks);
}

// K6d (K4d): as ptrt_pages_closest.
extern "C" int ptrt_pages_any(const float* page_tree, long long tc, const float* page_slot16,
                              long long sc16, int n_pages, const float* ox, const float* oy,
                              const float* oz, const float* dx, const float* dy, const float* dz,
                              const int* plo, const int* phi, const float* limit,
                              const uint8_t* found_in, int n, float t_min, uint8_t* found,
                              int* counter, int depth_class, int grid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::AnyKernel k = ptrt::any_variant(depth_class);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, 0, (cudaStream_t)stream>>>(
      page_tree, tc, page_slot16, sc16, n_pages, ox, oy, oz, dx, dy, dz, plo, phi, limit,
      found_in, n, t_min, found, counter);
  return (int)cudaGetLastError();
}

extern "C" int ptrt_pages_any_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::walk_occupancy(ptrt::any_variant(depth_class), stage, smem, blocks);
}
