// The BVH2 walks over the triangles: the closest hit below a scalar or
// per-ray bound, and occlusion below a per-ray limit (K4e).
//
// Replaces the JAX package's ops/pallas/bvh_pallas.py::_bvh_closest_kernel,
// _bvh_closest_ordered_kernel (entered there through _bvh_closest_unsorted),
// _bvh_any_kernel and _bvh_any_ordered_kernel (_bvh_any_unsorted).  On the
// TPU a block of rays walks the tree together from SMEM, a node visited
// when any lane of the block enters it, the ordered walk's near child
// chosen by the block's majority direction sign; here each thread walks its
// own ray over the records in device memory (through the read-only cache),
// its ordered near child chosen by its own direction sign, as
// bvh_walk.cuh's BVH4 walks do.  The route (ops/cuda/bvh.py tri_route)
// takes these walks where the BVH4 walks are not taken: a BVH4 deeper than
// their stack, or BVH_QUAD off.
//
// Kept exactly, per lane: the slab test of _slab and the Möller–Trumbore test
// of _leaf_tris (strict `<` against the running best, t > t_min, the 1e-12
// and 1e-6 guards); a leaf's slots are tested only when the lane enters its
// box (the JAX kernels' per-lane box mask); slot gids decoded by gid_mask.
// The skip-link walk visits the nodes in the plain walk's order, so its
// winner equals ops/bvh.traverse_closest's; the ordered walk's may differ
// only between triangles at exactly equal t.
//
// Records (ops/bvh.py pack_blobs): node record, 8 floats: lo, hi, the skip
// link (the next node when the box is missed or the subtree is done), and
// the slot base (a leaf, >= 0) or -(1 + split code) (an inner node, whose
// left child is the next record and right child the left child's skip).
// Slot record: the padded 16-float copy of bvh_walk.cuh's 13 floats
// (Slot16TriLeaf), which every walk here reads.
//
// What bounds them: latency.  A ray reads 24 B (28 B with its bound) and
// writes 8 B (1 B), against a walk of dozens of node records (32 B each)
// and leaves of 16 slot records, each read by a thread that follows its own
// path.
//
// The two skip-link walks are designed for Hopper
// (bvh2_closest_skiplink_persistent, bvh2_any_skiplink_persistent): the
// ordered walks' persistent blocks and lane counter; each node read as two
// 16-byte loads (its box, then its skip link and code), where the first
// designs read its floats one by one; leaves from the padded slot copy,
// four slots' loads issued together (Slot16TriLeaf).  No stack, and the
// same visit order, step guard and floats as the first designs (the
// closest walk's in git at 5d3f023, the occlusion walk's at f75eb47), so
// the closest walk's t and triangle and the occlusion walk's verdict are
// the same bits on every lane, per-ray bound or not.
//
// The two ordered walks are designed for Hopper (bvh2_closest_persistent,
// bvh2_any_persistent), as bvh_walk.cuh's persistent BVH4 walks are:
// persistent blocks of 256 threads whose warps take 32 lanes at a time from
// the stream's lane counter (next_lane); a node and its left child are
// consecutive 32 B records, so one visit reads the node as two 16-byte loads
// and its right child's index (the left child's skip) from a third issued
// with them, where the first design waited for the node before it read the
// index; leaves from the padded slot copy, four slots' loads issued together
// (Slot16TriLeaf); a stack sized by the tree's BVH2 depth class (kShallow2
// or kStack2Cap entries, ops/cuda/bvh.depth2_class), where the first design
// carried 768 B whatever the depth.  Each lane's floats and its order of
// tests are the first design's (the closest walk's in git at a3bb26a, the
// occlusion walk's at 762ff5c), so its results are too.  Occlusion is an
// existence test, so its verdict would not depend on the visit order; the
// walk keeps the near-first order all the same, as the TPU kernel's
// counterpart.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "sweep.cuh"

namespace ptrt {

constexpr int kNode2F = 8;
// the ordered walk's stack: ops/cuda/bvh.py STACK_CAP, the JAX _STACK_CAP; it
// holds at most depth2 + 1 nodes (the wrapper checks depth2 + 2 <= cap, and
// that its STACK_CAP equals ptrt_bvh2_stack_cap()).  A lane whose stack would
// overflow all the same finishes by the skip-link walk, from its running best.
constexpr int kStack2Cap = 192;
// the persistent ordered walks' smaller stack class (ops/cuda/bvh.py
// SHALLOW2): a BVH2 of depth2 + 2 <= kShallow2 takes it, any other kStack2Cap
constexpr int kShallow2 = 32;

// The skip-link walk of one ray, each node read as two 16-byte loads: the
// box, then the skip link and the code (an inner node's right child is not
// read: the walk takes the next record or the skip).  Its leaves are
// visited by `leaf` (Slot16TriLeaf).  Closest (kAny false): h carries the
// bound in and the winner (t, raw gid) out, the slab's far plane the
// running best.  Any: returns at the first hit below h.t, the fixed limit.
template <bool kAny, class Leaf>
__device__ __forceinline__ bool skiplink_walk(const float* __restrict__ tree, int m,
                                              const Leaf& leaf, const Ray& r, float t_min,
                                              Hit& h) {
  const WalkRay w = walk_ray(r);
  int cursor = 0;
  for (int step = 0; cursor < m && step <= m; ++step) {
    const float4* p = reinterpret_cast<const float4*>(tree + (size_t)cursor * kNode2F);
    const float4 lo = __ldg(p), hi = __ldg(p + 1);
    const float b[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
    const bool hit = slab(b, w, t_min, h.t);
    const float code = hi.w;
    if (hit && code >= 0.0f) {
      if constexpr (kAny) {
        if (leaf.any(code, r, t_min, h.t)) return true;
      } else {
        leaf.closest(code, r, t_min, 0, h);
      }
    }
    cursor = (hit && code < 0.0f) ? cursor + 1 : (int)hi.z;
  }
  return false;
}

// Node `node`'s record as two 16-byte loads into b, and its right child if
// it is an inner node: the skip of the next record (its left child), read by
// a third load issued with the first two (none past the last record).
__device__ __forceinline__ int load_node2(const float* __restrict__ tree, int m, int node,
                                          float (&b)[kNode2F]) {
  const float4* p = reinterpret_cast<const float4*>(tree + (size_t)node * kNode2F);
  const float4 lo = __ldg(p), hi = __ldg(p + 1);
  const float right = node + 1 < m ? __ldg(tree + (size_t)(node + 1) * kNode2F + 6) : -1.0f;
  b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
  b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
  return (int)right;
}

// The ordered walk, near child first (the JAX package's ordered kernels),
// with the node loads of load_node2 and a stack of kCap entries.  Closest
// (kAny false): h carries the bound in and the winner out, the slab's far
// plane the running best.  Any: returns at the first hit below h.t, the
// fixed limit.  A lane whose stack would overflow finishes by the skip-link
// walk from its running best or with its limit, as the first design's did
// (the wrapper picks a class that holds depth2 + 2, so only a tree past
// kStack2Cap would).
template <int kCap, bool kAny, class Leaf>
__device__ __forceinline__ bool ordered_walk(const float* __restrict__ tree, int m,
                                             const Leaf& leaf, const Ray& r, float t_min,
                                             Hit& h) {
  const WalkRay w = walk_ray(r);
  LocalStack<kCap> stack;
  stack.push(0);
  for (int step = 0; !stack.empty() && step < m + 2; ++step) {
    const int node = stack.pop();
    float b[kNode2F];
    const int right = load_node2(tree, m, node, b);
    if (!slab(b, w, t_min, h.t)) continue;
    const float code = b[7];
    if (code >= 0.0f) {
      if constexpr (kAny) {
        if (leaf.any(code, r, t_min, h.t)) return true;
      } else {
        leaf.closest(code, r, t_min, 0, h);
      }
      continue;
    }
    if (stack.sp + 2 > kCap) return skiplink_walk<kAny>(tree, m, leaf, r, t_min, h);
    const bool left_near = near_first(-code - 1.0f, r);
    stack.push(left_near ? right : node + 1);  // the near child is popped first
    stack.push(left_near ? node + 1 : right);
  }
  return false;
}

// The skip-link closest walk for Hopper: lanes [0, n) taken 32 at a time
// from `counter` (two int32, zero at the launch, left zero; finish_lanes).
// No minimum of resident blocks: 79 registers, 3 blocks an SM; asked for 4
// or 5 it spills and measured slower on an H100 on every ray set (PERF.md).
__global__ void __launch_bounds__(kWalkThreads)
bvh2_closest_skiplink_persistent(const float* __restrict__ tree, int m,
                                 const float* __restrict__ slot16,
                                 const float* __restrict__ ox_in, const float* __restrict__ oy_in,
                                 const float* __restrict__ oz_in, const float* __restrict__ dx_in,
                                 const float* __restrict__ dy_in, const float* __restrict__ dz_in,
                                 int n, int gid_mask, float t_min, float t_max,
                                 const float* __restrict__ bound, float* __restrict__ t_out,
                                 int* __restrict__ tri_out, int* __restrict__ counter) {
  const Slot16TriLeaf leaf{reinterpret_cast<const float4*>(slot16)};
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    const Ray r = load_ray(ox_in, oy_in, oz_in, dx_in, dy_in, dz_in, i);
    Hit h;
    h.t = bound ? bound[i] : t_max;
    h.prim = -1;
    skiplink_walk<false>(tree, m, leaf, r, t_min, h);
    t_out[i] = h.t;
    tri_out[i] = decode_prim(h.prim, 0, gid_mask);
  }
  finish_lanes(counter);
}

// The ordered closest walk for Hopper: lanes [0, n) taken 32 at a time from
// `counter` (two int32, zero at the launch, left zero; finish_lanes).
template <int kCap>
__global__ void __launch_bounds__(kWalkThreads, 2)
bvh2_closest_persistent(const float* __restrict__ tree, int m, const float* __restrict__ slot16,
                        const float* __restrict__ ox_in, const float* __restrict__ oy_in,
                        const float* __restrict__ oz_in, const float* __restrict__ dx_in,
                        const float* __restrict__ dy_in, const float* __restrict__ dz_in, int n,
                        int gid_mask, float t_min, float t_max, const float* __restrict__ bound,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        int* __restrict__ counter) {
  const Slot16TriLeaf leaf{reinterpret_cast<const float4*>(slot16)};
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    const Ray r = load_ray(ox_in, oy_in, oz_in, dx_in, dy_in, dz_in, i);
    Hit h;
    h.t = bound ? bound[i] : t_max;
    h.prim = -1;
    ordered_walk<kCap, false>(tree, m, leaf, r, t_min, h);
    t_out[i] = h.t;
    tri_out[i] = decode_prim(h.prim, 0, gid_mask);
  }
  finish_lanes(counter);
}

// The skip-link occlusion walk for Hopper: lanes as
// bvh2_closest_skiplink_persistent takes them; a lane whose limit is <= 0 is
// written occluded and loads no ray, as the first design did.  No minimum
// of resident blocks: 78 registers, no spill, 3 blocks an SM; asked for 4
// (at most 64 registers) it spills 48 B and measured slower on an H100 on
// every ray set, 2.7x on the 190-deep chain (PERF.md).
__global__ void __launch_bounds__(kWalkThreads)
bvh2_any_skiplink_persistent(const float* __restrict__ tree, int m,
                             const float* __restrict__ slot16, const float* __restrict__ ox_in,
                             const float* __restrict__ oy_in, const float* __restrict__ oz_in,
                             const float* __restrict__ dx_in, const float* __restrict__ dy_in,
                             const float* __restrict__ dz_in, const float* __restrict__ limit_in,
                             int n, float t_min, uint8_t* __restrict__ occ_out,
                             int* __restrict__ counter) {
  const Slot16TriLeaf leaf{reinterpret_cast<const float4*>(slot16)};
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    Hit h;
    h.t = limit_in[i];
    if (h.t <= 0.0f) {  // no answer needed: reported occluded, as the JAX kernels do
      occ_out[i] = 1;
      continue;
    }
    const Ray r = load_ray(ox_in, oy_in, oz_in, dx_in, dy_in, dz_in, i);
    occ_out[i] = skiplink_walk<true>(tree, m, leaf, r, t_min, h) ? 1 : 0;
  }
  finish_lanes(counter);
}

// The ordered occlusion walk for Hopper: lanes as bvh2_closest_persistent
// takes them; a lane whose limit is <= 0 is written occluded with no walk.
// Two resident blocks of 256 at least, as the other persistent walks: 78
// registers, no spill (3 blocks an SM).  Fewer registers for more resident
// warps (bounds of 3-5 blocks, batches of one or two slots) measured slower
// on an H100 on every ray set of config 5 but the one where every ray hits
// (PERF.md).
template <int kCap>
__global__ void __launch_bounds__(kWalkThreads, 2)
bvh2_any_persistent(const float* __restrict__ tree, int m, const float* __restrict__ slot16,
                    const float* __restrict__ ox_in, const float* __restrict__ oy_in,
                    const float* __restrict__ oz_in, const float* __restrict__ dx_in,
                    const float* __restrict__ dy_in, const float* __restrict__ dz_in,
                    const float* __restrict__ limit_in, int n, float t_min,
                    uint8_t* __restrict__ occ_out, int* __restrict__ counter) {
  const Slot16TriLeaf leaf{reinterpret_cast<const float4*>(slot16)};
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    Hit h;
    h.t = limit_in[i];
    if (h.t <= 0.0f) {  // no answer needed: reported occluded, as the JAX kernels do
      occ_out[i] = 1;
      continue;
    }
    const Ray r = load_ray(ox_in, oy_in, oz_in, dx_in, dy_in, dz_in, i);
    occ_out[i] = ordered_walk<kCap, true>(tree, m, leaf, r, t_min, h) ? 1 : 0;
  }
  finish_lanes(counter);
}

using Closest2Kernel = decltype(&bvh2_closest_persistent<kStack2Cap>);
using Any2Kernel = decltype(&bvh2_any_persistent<kStack2Cap>);

// The ordered walks' variants (ops/cuda/bvh.depth2_class): one per stack
// class; nullptr for any other class.
inline Closest2Kernel closest2_variant(int depth_class) {
  if (depth_class == kShallow2) return bvh2_closest_persistent<kShallow2>;
  if (depth_class == kStack2Cap) return bvh2_closest_persistent<kStack2Cap>;
  return nullptr;
}

inline Any2Kernel any2_variant(int depth_class) {
  if (depth_class == kShallow2) return bvh2_any_persistent<kShallow2>;
  if (depth_class == kStack2Cap) return bvh2_any_persistent<kStack2Cap>;
  return nullptr;
}

}  // namespace ptrt

// The ordered walk's stack, in nodes (kStack2Cap).
extern "C" int ptrt_bvh2_stack_cap() { return ptrt::kStack2Cap; }

// Each launches on `stream`, allocates nothing and does not synchronise, and
// returns the launch's cudaError_t (0 when the launch was accepted).
// `bound` may be null: every ray then starts from t_max.  Both walks read
// the padded `slot16`, `tree` 16-byte aligned, in `grid` persistent blocks
// on the lane `counter` (two int32, zero at the launch and left zero): the
// skip-link walk (ordered 0), sized by ptrt_bvh2_skiplink_occupancy, or the
// ordered walk (ordered 1)'s variant for depth_class (kShallow2 or
// kStack2Cap), sized by ptrt_bvh2_closest_occupancy.
extern "C" int ptrt_bvh2_closest(const float* tree, int m, const float* slot16, const float* ox,
                                 const float* oy, const float* oz, const float* dx,
                                 const float* dy, const float* dz, int n, int ordered,
                                 int gid_mask, float t_min, float t_max, const float* bound,
                                 float* t, int* tri, int* counter, int depth_class, int grid,
                                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (ordered) {
    const ptrt::Closest2Kernel k = ptrt::closest2_variant(depth_class);
    if (k == nullptr) return (int)cudaErrorInvalidValue;
    k<<<grid, ptrt::kWalkThreads, 0, s>>>(tree, m, slot16, ox, oy, oz, dx, dy, dz, n, gid_mask,
                                          t_min, t_max, bound, t, tri, counter);
  } else {
    ptrt::bvh2_closest_skiplink_persistent<<<grid, ptrt::kWalkThreads, 0, s>>>(
        tree, m, slot16, ox, oy, oz, dx, dy, dz, n, gid_mask, t_min, t_max, bound, t, tri,
        counter);
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the ordered closest walk's variant for
// depth_class, into *blocks: it stages nothing (stage and smem must be 0).
extern "C" int ptrt_bvh2_closest_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::walk_occupancy(ptrt::closest2_variant(depth_class), stage, smem, blocks);
}

// Resident blocks per SM of the skip-link closest walk, into *blocks: it
// has no stack (depth_class 0) and stages nothing (stage and smem 0).
extern "C" int ptrt_bvh2_skiplink_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::walk_occupancy(depth_class == 0 ? &ptrt::bvh2_closest_skiplink_persistent : nullptr,
                              stage, smem, blocks);
}

// The occlusion walks as ptrt_bvh2_closest's: the skip-link walk (ordered
// 0), sized by ptrt_bvh2_skiplink_any_occupancy, or the ordered walk
// (ordered 1)'s variant for depth_class, sized by ptrt_bvh2_any_occupancy.
// Lanes whose limit is <= 0 are reported occluded.
extern "C" int ptrt_bvh2_any(const float* tree, int m, const float* slot16, const float* ox,
                             const float* oy, const float* oz, const float* dx, const float* dy,
                             const float* dz, const float* limit, int n, int ordered, float t_min,
                             uint8_t* occluded, int* counter, int depth_class, int grid,
                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (ordered) {
    const ptrt::Any2Kernel k = ptrt::any2_variant(depth_class);
    if (k == nullptr) return (int)cudaErrorInvalidValue;
    k<<<grid, ptrt::kWalkThreads, 0, s>>>(tree, m, slot16, ox, oy, oz, dx, dy, dz, limit, n,
                                          t_min, occluded, counter);
  } else {
    ptrt::bvh2_any_skiplink_persistent<<<grid, ptrt::kWalkThreads, 0, s>>>(
        tree, m, slot16, ox, oy, oz, dx, dy, dz, limit, n, t_min, occluded, counter);
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the skip-link occlusion walk, into *blocks: no
// stack (depth_class 0), nothing staged (stage and smem 0).
extern "C" int ptrt_bvh2_skiplink_any_occupancy(int stage, int depth_class, int smem,
                                                int* blocks) {
  return ptrt::walk_occupancy(depth_class == 0 ? &ptrt::bvh2_any_skiplink_persistent : nullptr,
                              stage, smem, blocks);
}

// Resident blocks per SM of the ordered occlusion walk's variant for
// depth_class, into *blocks: it stages nothing (stage and smem must be 0).
extern "C" int ptrt_bvh2_any_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::walk_occupancy(ptrt::any2_variant(depth_class), stage, smem, blocks);
}
