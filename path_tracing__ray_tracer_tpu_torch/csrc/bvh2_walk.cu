// The BVH2 walks over the triangles, one ray per thread: the closest hit
// below a scalar or per-ray bound, and occlusion below a per-ray limit (K4e).
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
// Slot record, 13 floats, as bvh_walk.cuh.
//
// What bounds them: latency.  A ray reads 24 B (28 B with its bound) and
// writes 8 B (1 B), against a walk of dozens of node records (32 B each)
// and leaves of 16 slot records (52 B each), each read by a thread that
// follows its own path.  The design keeps it simple: one thread per ray,
// the ordered stack in local memory, the records as packed.
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
constexpr int kBvh2Threads = 128;

// The leaf's slots below the running best: the first least t wins.
__device__ __forceinline__ void leaf_closest(const float* __restrict__ slots, int base,
                                             const Ray& r, float t_min, float& bt, int& bi) {
  const float* s = slots + (size_t)base * kSlotF;
  for (int k = 0; k < kLeafSize; ++k, s += kSlotF) {
    float tt, bu, bv;
    if (moller_trumbore(s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], r, t_min, bt, tt,
                        bu, bv) &&
        s[9] >= 0.0f) {
      bt = tt;
      bi = (int)s[9];
    }
  }
}

__device__ __forceinline__ bool leaf_any(const float* __restrict__ slots, int base, const Ray& r,
                                         float t_min, float limit) {
  const float* s = slots + (size_t)base * kSlotF;
  for (int k = 0; k < kLeafSize; ++k, s += kSlotF) {
    float tt, bu, bv;
    if (moller_trumbore(s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], r, t_min, limit,
                        tt, bu, bv) &&
        s[9] >= 0.0f)
      return true;
  }
  return false;
}

// The walk of one ray.  Closest (kAny false): bt/bi carry the bound in and
// the winner out, the slab's far plane the running best.  Any: returns at
// the first hit below `bt`, the fixed limit.
template <bool kOrdered, bool kAny>
__device__ __forceinline__ bool walk2(const float* __restrict__ tree, int m,
                                      const float* __restrict__ slots, const Ray& r, float t_min,
                                      float& bt, int& bi) {
  const WalkRay w = walk_ray(r);
  if constexpr (kOrdered) {
    int stack[kStack2Cap];
    int sp = 0;
    stack[sp++] = 0;
    for (int step = 0; sp > 0 && step < m + 2; ++step) {
      const int node = stack[--sp];
      const float* b = tree + (size_t)node * kNode2F;
      if (!slab(b, w, t_min, bt)) continue;
      const float code = b[7];
      if (code >= 0.0f) {
        if constexpr (kAny) {
          if (leaf_any(slots, (int)code, r, t_min, bt)) return true;
        } else {
          leaf_closest(slots, (int)code, r, t_min, bt, bi);
        }
        continue;
      }
      if (sp + 2 > kStack2Cap) return walk2<false, kAny>(tree, m, slots, r, t_min, bt, bi);
      const int left = node + 1;
      const int right = (int)tree[(size_t)left * kNode2F + 6];
      const bool left_near = near_first(-code - 1.0f, r);
      stack[sp++] = left_near ? right : left;  // the near child is popped first
      stack[sp++] = left_near ? left : right;
    }
  } else {
    int cursor = 0;
    for (int step = 0; cursor < m && step <= m; ++step) {
      const float* b = tree + (size_t)cursor * kNode2F;
      const bool hit = slab(b, w, t_min, bt);
      const float code = b[7];
      if (hit && code >= 0.0f) {
        if constexpr (kAny) {
          if (leaf_any(slots, (int)code, r, t_min, bt)) return true;
        } else {
          leaf_closest(slots, (int)code, r, t_min, bt, bi);
        }
      }
      cursor = (hit && code < 0.0f) ? cursor + 1 : (int)b[6];
    }
  }
  return false;
}

template <bool kOrdered>
__global__ void __launch_bounds__(kBvh2Threads)
bvh2_closest_kernel(const float* __restrict__ tree, int m, const float* __restrict__ slots,
                    const float* __restrict__ ox_in, const float* __restrict__ oy_in,
                    const float* __restrict__ oz_in, const float* __restrict__ dx_in,
                    const float* __restrict__ dy_in, const float* __restrict__ dz_in, int n,
                    int gid_mask, float t_min, float t_max, const float* __restrict__ bound,
                    float* __restrict__ t_out, int* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = ox_in[i]; r.oy = oy_in[i]; r.oz = oz_in[i];
  r.dx = dx_in[i]; r.dy = dy_in[i]; r.dz = dz_in[i];
  float bt = bound ? bound[i] : t_max;
  int bi = -1;
  walk2<kOrdered, false>(tree, m, slots, r, t_min, bt, bi);
  t_out[i] = bt;
  tri_out[i] = decode_prim(bi, 0, gid_mask);
}

template <bool kOrdered>
__global__ void __launch_bounds__(kBvh2Threads)
bvh2_any_kernel(const float* __restrict__ tree, int m, const float* __restrict__ slots,
                const float* __restrict__ ox_in, const float* __restrict__ oy_in,
                const float* __restrict__ oz_in, const float* __restrict__ dx_in,
                const float* __restrict__ dy_in, const float* __restrict__ dz_in,
                const float* __restrict__ limit_in, int n, float t_min,
                uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float limit = limit_in[i];
  if (limit <= 0.0f) {  // no answer needed: reported occluded, as the JAX kernels do
    occ_out[i] = 1;
    return;
  }
  Ray r;
  r.ox = ox_in[i]; r.oy = oy_in[i]; r.oz = oz_in[i];
  r.dx = dx_in[i]; r.dy = dy_in[i]; r.dz = dz_in[i];
  int unused = -1;
  occ_out[i] = walk2<kOrdered, true>(tree, m, slots, r, t_min, limit, unused) ? 1 : 0;
}

inline int blocks2_for(int n) { return (n + kBvh2Threads - 1) / kBvh2Threads; }

}  // namespace ptrt

// The ordered walk's stack, in nodes (kStack2Cap).
extern "C" int ptrt_bvh2_stack_cap() { return ptrt::kStack2Cap; }

// Both launch on `stream`, allocate nothing and do not synchronise.  Each
// returns the launch's cudaError_t (0 when the launch was accepted).
// `bound` may be null: every ray then starts from t_max.
extern "C" int ptrt_bvh2_closest(const float* tree, int m, const float* slots, const float* ox,
                                 const float* oy, const float* oz, const float* dx,
                                 const float* dy, const float* dz, int n, int ordered,
                                 int gid_mask, float t_min, float t_max, const float* bound,
                                 float* t, int* tri, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = ptrt::blocks2_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (ordered)
    ptrt::bvh2_closest_kernel<true><<<blocks, ptrt::kBvh2Threads, 0, s>>>(
        tree, m, slots, ox, oy, oz, dx, dy, dz, n, gid_mask, t_min, t_max, bound, t, tri);
  else
    ptrt::bvh2_closest_kernel<false><<<blocks, ptrt::kBvh2Threads, 0, s>>>(
        tree, m, slots, ox, oy, oz, dx, dy, dz, n, gid_mask, t_min, t_max, bound, t, tri);
  return (int)cudaGetLastError();
}

extern "C" int ptrt_bvh2_any(const float* tree, int m, const float* slots, const float* ox,
                             const float* oy, const float* oz, const float* dx, const float* dy,
                             const float* dz, const float* limit, int n, int ordered, float t_min,
                             uint8_t* occluded, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = ptrt::blocks2_for(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (ordered)
    ptrt::bvh2_any_kernel<true><<<blocks, ptrt::kBvh2Threads, 0, s>>>(
        tree, m, slots, ox, oy, oz, dx, dy, dz, limit, n, t_min, occluded);
  else
    ptrt::bvh2_any_kernel<false><<<blocks, ptrt::kBvh2Threads, 0, s>>>(
        tree, m, slots, ox, oy, oz, dx, dy, dz, limit, n, t_min, occluded);
  return (int)cudaGetLastError();
}
