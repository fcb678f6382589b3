// Whole-scene intersection of a BVH scene, one ray per thread: the closest
// hit with its attributes (K4a) and the occlusion test with a per-ray bound
// (K4b); and the rooted triangle walk of the multipass route (K11).
//
// Replaces the JAX package's ops/pallas/bvh_pallas.py::
// _bvh4_scene_closest_kernel (entered there through bvh_scene_closest_pallas)
// and ::_bvh4_scene_any_kernel (bvh_scene_any_pallas).  Both first sweep the
// planes, spheres and quads (sweep.cuh, from shared memory); that result
// seeds the triangle walk of bvh_walk.cuh, so triangles behind a nearer
// plane/sphere/quad are never tested.
//
// What bounds them: latency.  Per ray K4a reads 24 B and writes 28 B, K4b
// reads 28 B and writes 1 B, against a walk of tens of node records and
// leaves of 16 slot records, read from device memory through the read-only
// cache by threads that each follow their own path, so a lane's time is its
// chain of dependent loads.
//
// All three are designed for Hopper (bvh_closest_persistent,
// bvh_any_persistent, bvh4_rooted_persistent): persistent blocks of 256
// threads, as many as are resident, whose warps take 32 lanes at a time from
// a counter (K4a: a static first batch, then next_batch; K4b, K11:
// next_lane); the plane/sphere/quad blob copied into shared memory once per
// resident block (K4a, K4b); the BVH4 node table read from device memory as
// eight 16-byte loads a node (K4b: or copied into each block's shared memory
// by one bulk copy (TMA) when it fits the budget of ops/cuda/bvh.py); the slot
// records read from the padded 64 B copy as 16-byte loads, four slots a
// batch; a stack of 3 * depth class - 2 entries in local memory.  The
// wrapper picks the variant by size alone (ops/cuda/bvh.closest_plan,
// walk_plan, rooted_plan).  Each lane's arithmetic and visit order are the
// first design's, so its results are too (the first designs, one lane per
// thread in blocks of 128 with a stack of 96 entries: K4b at edf8737, K11 at
// a3bb26a, K4a, which read the 13-float slot records float by float, at
// 41c504a).  K4a's first batch is static, so a launch whose grid spans its
// lanes (the mesh Whitted frame's compacted later bounces) touches no counter.
//
// K4a outputs: t (the bound on a miss), prim (global id, -1 on a miss; the
// uid bits of a packed gid stripped by gid_mask), u, v
// (the plane/sphere/quad winner's surface UV, a triangle winner's raw
// barycentrics), the shading normal (triangles flipped toward the ray;
// zeros on a miss).  K4b: one byte per ray, 1 when occluded in
// (t_min, limit[i]); lanes with limit <= 0 (no answer needed) report 1.
//
// K11 replaces ops/pallas/bvh_pallas.py::_bvh4_closest_rooted_kernel
// (entered through _bvh_closest_rooted, driven by _bvh_closest_multipass):
// one pass of the triangle-only BVH4 walk from a subtree root with the
// lane's carried (best t, triangle).  The TPU kernel takes one root per
// block of 1,024 coherence-sorted rays and masks the lanes that want
// another; here each lane walks from its own root (roots[i]), so no sort is
// needed, and lanes with en[i] = 0 pass their carried pair through.  The
// triangle id comes out decoded (local, the uid stripped by gid_mask);
// decoding a carried id again leaves it unchanged.  Bound: latency, as K4a;
// it reads 9 B a lane and 28 B more where en[i], writes 8 B.  Its leaves
// keep only t and the triangle (Slot16TriLeaf), and its stack class comes
// from the whole tree's depth: a walk from a subtree root is shallower.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "sweep.cuh"

namespace ptrt {

// K4a for Hopper: the sweep's record, then the walk's, for lanes [0, n)
// (scene_closest_lanes).
template <int kClass>
__global__ void __launch_bounds__(kWalkThreads, 2)
bvh_closest_persistent(const float* __restrict__ nodes, int n_nodes,
                       const float* __restrict__ slot16, const float* __restrict__ ps_g, int P,
                       int S, int Q, const float* __restrict__ ox, const float* __restrict__ oy,
                       const float* __restrict__ oz, const float* __restrict__ dx,
                       const float* __restrict__ dy, const float* __restrict__ dz, int n,
                       int gid_mask, float t_min, float t_max, float* __restrict__ t_out,
                       int* __restrict__ prim_out, float* __restrict__ u_out,
                       float* __restrict__ v_out, float* __restrict__ nx_out,
                       float* __restrict__ ny_out, float* __restrict__ nz_out,
                       int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  float* ps = reinterpret_cast<float*>(smem4);
  const SceneLayout L = scene_layout(P, S, Q, 0);
  stage_blob(ps, ps_g, L.tb);
  const Slot16Leaf leaf{reinterpret_cast<const float4*>(slot16)};
  scene_closest_lanes<kClass>(ps, L, Vec4Nodes<false>{reinterpret_cast<const float4*>(nodes)},
                              n_nodes, [&](const Ray&) { return leaf; }, ox, oy, oz, dx, dy, dz,
                              n, gid_mask, t_min, t_max, t_out, prim_out, u_out, v_out, nx_out,
                              ny_out, nz_out, counter);
}

// K4b for Hopper: the occlusion of lanes [0, n) taken 32 at a time from
// `counter` (two int32, zero at the launch, left zero; finish_lanes).
template <bool kStage, int kDepth>
__global__ void __launch_bounds__(kWalkThreads, 2)
bvh_any_persistent(const float* __restrict__ nodes, int n_nodes,
                   const float* __restrict__ slot16, const float* __restrict__ ps_g, int P,
                   int S, int Q, const float* __restrict__ ox_in,
                   const float* __restrict__ oy_in, const float* __restrict__ oz_in,
                   const float* __restrict__ dx_in, const float* __restrict__ dy_in,
                   const float* __restrict__ dz_in, const float* __restrict__ limit_in, int n,
                   float t_min, uint8_t* __restrict__ occ_out, int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bar;
  const SceneLayout L = scene_layout(P, S, Q, 0);
  float* tree = reinterpret_cast<float*>(smem4);
  float* ps = tree + tree_smem_bytes(kStage, n_nodes) / sizeof(float);
  if (kStage && threadIdx.x == 0)
    bulk_copy_start(tree, nodes, (uint32_t)tree_smem_bytes(kStage, n_nodes), &bar);
  stage_blob(ps, ps_g, L.tb);
  if (kStage) bulk_copy_wait(&bar);
  const Vec4Nodes<kStage> src{reinterpret_cast<const float4*>(kStage ? tree : nodes)};
  const Slot16Leaf leaf{reinterpret_cast<const float4*>(slot16)};
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    Ray r;
    r.ox = ox_in[i]; r.oy = oy_in[i]; r.oz = oz_in[i];
    r.dx = dx_in[i]; r.dy = dy_in[i]; r.dz = dz_in[i];
    const float limit = limit_in[i];
    bool occ = limit <= 0.0f || any_hit(ps, L, r, t_min, limit);
    if (!occ) {
      LocalStack<stack_cap(kDepth)> stack;
      occ = walk_any_with<false>(src, n_nodes, leaf, stack, r, t_min, limit, nullptr);
    }
    occ_out[i] = occ ? 1 : 0;
  }
  finish_lanes(counter);
}

// K11 for Hopper: one pass over lanes [0, n), taken 32 at a time from
// `counter` (two int32, zero at the launch, left zero; finish_lanes).
template <int kDepth>
__global__ void __launch_bounds__(kWalkThreads, 2)
bvh4_rooted_persistent(const float* __restrict__ nodes, int n_nodes,
                       const float* __restrict__ slot16, const float* __restrict__ ox_in,
                       const float* __restrict__ oy_in, const float* __restrict__ oz_in,
                       const float* __restrict__ dx_in, const float* __restrict__ dy_in,
                       const float* __restrict__ dz_in, const int* __restrict__ roots,
                       const uint8_t* __restrict__ en, const float* __restrict__ bt0,
                       const int* __restrict__ bi0, int n, int gid_mask, float t_min,
                       float* __restrict__ bt_out, int* __restrict__ bi_out,
                       int* __restrict__ counter) {
  const Vec4Nodes<false> src{reinterpret_cast<const float4*>(nodes)};
  const Slot16TriLeaf leaf{reinterpret_cast<const float4*>(slot16)};
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    Hit h;
    h.t = bt0[i];
    h.prim = bi0[i];
    if (en[i]) {
      const Ray r = load_ray(ox_in, oy_in, oz_in, dx_in, dy_in, dz_in, i);
      LocalStack<stack_cap(kDepth)> stack;
      walk_closest_with<false>(src, n_nodes, leaf, stack, r, t_min, 0, h, nullptr, roots[i]);
      h.prim = decode_prim(h.prim, 0, gid_mask);
    }
    bt_out[i] = h.t;
    bi_out[i] = h.prim;
  }
  finish_lanes(counter);
}

using ClosestKernel = decltype(&bvh_closest_persistent<kMaxDepth4>);
using AnyKernel = decltype(&bvh_any_persistent<false, kMaxDepth4>);
using RootedKernel = decltype(&bvh4_rooted_persistent<kMaxDepth4>);

// The variants the wrapper picks among (ops/cuda/bvh.walk_plan): the tree
// staged or not, for either depth class; nullptr for any other class.
inline AnyKernel any_variant(int stage, int depth_class) {
  if (depth_class == kShallow4)
    return stage ? bvh_any_persistent<true, kShallow4> : bvh_any_persistent<false, kShallow4>;
  if (depth_class == kMaxDepth4)
    return stage ? bvh_any_persistent<true, kMaxDepth4> : bvh_any_persistent<false, kMaxDepth4>;
  return nullptr;
}

// K4a's variants (ops/cuda/bvh.closest_plan): one per depth class; nullptr
// for any other class.
inline ClosestKernel closest_variant(int depth_class) {
  if (depth_class == kShallow4) return bvh_closest_persistent<kShallow4>;
  if (depth_class == kMaxDepth4) return bvh_closest_persistent<kMaxDepth4>;
  return nullptr;
}

// K11's variants (ops/cuda/bvh.rooted_plan): one per depth class.
inline RootedKernel rooted_variant(int depth_class) {
  if (depth_class == kShallow4) return bvh4_rooted_persistent<kShallow4>;
  if (depth_class == kMaxDepth4) return bvh4_rooted_persistent<kMaxDepth4>;
  return nullptr;
}

}  // namespace ptrt

// Each launches on `stream`, allocates nothing and does not synchronise, and
// returns the launch's cudaError_t (0 when the launch was accepted).

// Resident blocks per SM of K4a's variant for depth_class with `smem` bytes
// of dynamic shared memory (the plane/sphere/quad blob), into *blocks; it
// stages no tree (stage must be 0).  First lifts the variant's dynamic
// shared memory limit to `smem` where it is lower.
extern "C" int ptrt_bvh_closest_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::table_occupancy(ptrt::closest_variant(depth_class), stage, smem, blocks);
}

// K4a: `grid` persistent blocks of the variant for depth_class with `smem`
// bytes of dynamic shared memory, which ptrt_bvh_closest_occupancy has sized
// and allowed, on the lane `counter` (two int32, zero at the launch and left
// zero).  `slot16`: the padded slot records; `nodes` and `slot16` 16-byte
// aligned.
extern "C" int ptrt_bvh_closest(const float* nodes, int n_nodes, const float* slot16,
                                const float* ps, int P, int S, int Q, const float* ox,
                                const float* oy, const float* oz, const float* dx,
                                const float* dy, const float* dz, int n, int gid_mask,
                                float t_min, float t_max, float* t, int* prim, float* u, float* v,
                                float* nx, float* ny, float* nz, int* counter, int depth_class,
                                int smem, int grid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::ClosestKernel k = ptrt::closest_variant(depth_class);
  if (k == nullptr || (size_t)smem < ptrt::blob_bytes(P, S, Q))
    return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, smem, (cudaStream_t)stream>>>(
      nodes, n_nodes, slot16, ps, P, S, Q, ox, oy, oz, dx, dy, dz, n, gid_mask, t_min, t_max, t,
      prim, u, v, nx, ny, nz, counter);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the K4b variant (stage, depth_class) with
// `smem` bytes of dynamic shared memory, into *blocks; first lifts the
// variant's dynamic shared memory limit to `smem` where it is lower.
extern "C" int ptrt_bvh_any_occupancy(int stage, int depth_class, int smem, int* blocks) {
  const ptrt::AnyKernel k = ptrt::any_variant(stage, depth_class);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = ptrt::allow_smem(k, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, ptrt::kWalkThreads, smem);
  return (int)err;
}

// K4b: `grid` persistent blocks of the variant (stage, depth_class) with
// `smem` bytes of dynamic shared memory, which ptrt_bvh_any_occupancy has
// allowed; `counter` is two int32 of scratch, zero at the launch and left
// zero by the kernel.
extern "C" int ptrt_bvh_any(const float* nodes, int n_nodes, const float* slot16, const float* ps,
                            int P, int S, int Q, const float* ox, const float* oy,
                            const float* oz, const float* dx, const float* dy, const float* dz,
                            const float* limit, int n, float t_min, uint8_t* occluded,
                            int* counter, int stage, int depth_class, int smem, int grid,
                            void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::AnyKernel k = ptrt::any_variant(stage, depth_class);
  if (k == nullptr ||
      (size_t)smem < ptrt::tree_smem_bytes(stage, n_nodes) + ptrt::blob_bytes(P, S, Q))
    return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, smem, (cudaStream_t)stream>>>(
      nodes, n_nodes, slot16, ps, P, S, Q, ox, oy, oz, dx, dy, dz, limit, n, t_min, occluded,
      counter);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of K11's variant for depth_class, into *blocks: it
// stages nothing (stage and smem must be 0).
extern "C" int ptrt_bvh4_rooted_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::walk_occupancy(ptrt::rooted_variant(depth_class), stage, smem, blocks);
}

// K11: `grid` persistent blocks of the variant for depth_class, which
// ptrt_bvh4_rooted_occupancy has sized; `counter` as K4b's.  `slot16`: the
// padded slot records; `nodes` and `slot16` 16-byte aligned.
extern "C" int ptrt_bvh4_closest_rooted(const float* nodes, int n_nodes, const float* slot16,
                                        const float* ox, const float* oy, const float* oz,
                                        const float* dx, const float* dy, const float* dz,
                                        const int* roots, const uint8_t* en, const float* bt0,
                                        const int* bi0, int n, int gid_mask, float t_min,
                                        float* bt, int* bi, int* counter, int depth_class,
                                        int grid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::RootedKernel k = ptrt::rooted_variant(depth_class);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, 0, (cudaStream_t)stream>>>(nodes, n_nodes, slot16, ox, oy, oz,
                                                           dx, dy, dz, roots, en, bt0, bi0, n,
                                                           gid_mask, t_min, bt, bi, counter);
  return (int)cudaGetLastError();
}
