// The BVH4 walks whose leaf visit reads the leaf coefficient table (K10),
// one ray per thread: the whole-scene closest hit (K10a) and occlusion
// (K10b), and the triangle-only closest hit from a carried record (K10c) and
// occlusion from a carried verdict (K10d).
//
// Replaces the JAX package's ops/pallas/bvh_pallas.py::
// _bvh4_scene_closest_mxu_kernel (K10a, entered through
// bvh_scene_closest_pallas), _bvh4_scene_any_mxu_kernel (K10b,
// bvh_scene_any_pallas), _bvh4_closest_attrs_mxu_kernel (K10c,
// bvh_closest_attrs_pallas) and _bvh4_any_mxu_kernel (K10d, _bvh_any_unsorted):
// K4a-K4d with each 16-triangle leaf tested as one (128, W) × (16, W) MXU
// product of its table slice and the block's ray features, then sign tests.
// Here there is no matrix unit to feed: each thread walks its own ray with
// bvh_walk.cuh's walk and evaluates the same linear forms in FP32 (MatQuadLeaf):
// 19 coefficients and about 40 operations a slot, against Möller–Trumbore's
// 13 floats of slot record.  The features are computed once per walk in
// registers.  No tensor core: lanes of one warp visit different leaves.
//
// What bounds them: latency, as K4a-K4d (dependent node and table loads from
// device memory through the read-only cache, one ray per thread).  Per ray
// K10a reads 24 B and writes 28 B, K10b reads 28 B and writes 1 B, K10c reads
// 52 B and writes 28 B, K10d reads 29 B and writes 1 B.  The table is 8 KB a
// leaf (16 rows × 128 columns), ten times the leaf's slot records.
//
// All four are designed for Hopper (mat_scene_closest_persistent,
// mat_scene_any_persistent, mat_tri_closest_persistent,
// mat_tri_any_persistent), as the page walks are (bvh_paged.cu): persistent
// blocks of 256 threads whose warps take 32 lanes at a time from the stream's
// lane counter (K10a: a static first batch, then next_batch, as its twin K4a
// in bvh_scene.cu, through the same body, scene_closest_lanes); the node
// records as eight 16-byte loads (Vec4Nodes); a stack of 3·class − 2 entries
// by the tree's depth class (ops/cuda/bvh.depth_class: 22 for config 5, where
// the first designs carried 96); the table read as 16-byte loads over four
// slots, a batch at a time (MatQuadLeaf).  K10a and K10b copy the
// plane/sphere/quad blob into shared memory once per resident block, as
// K4a and K4b do, not once per block of 128 lanes.  Each lane's floats and
// its order of tests are the first design's (K10c's in git at 762ff5c, K10b's
// and K10d's at 359e47e, K10a's at 41c504a: one thread a lane in blocks of
// 128, the node records read float by float, each slot's 19 coefficients as
// separate 4-byte loads from feature rows G·512 B apart), so its record or
// verdict is too.
//
// Outputs as bvh_scene.cu's K4a/K4b and bvh_paged.cu's whole-tree K4c/K4d:
// records finished by finish_hit (the uid bits of a packed gid stripped by
// gid_mask, triangle normals flipped toward the ray, raw barycentrics as u,
// v); K10b reports lanes with limit <= 0 as occluded, K10d carries found_in
// and walks the other lanes with their limit.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "sweep.cuh"

namespace ptrt {

// K10a for Hopper: the sweep's record, then the walk's, for lanes [0, n)
// (scene_closest_lanes), each lane's leaves tested by its own features.
template <int kClass>
__global__ void __launch_bounds__(kWalkThreads, 2)
mat_scene_closest_persistent(const float* __restrict__ nodes, int n_nodes,
                             const float* __restrict__ mat, long long stride,
                             const float* __restrict__ ps_g, int P, int S, int Q,
                             const float* __restrict__ ox, const float* __restrict__ oy,
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
  scene_closest_lanes<kClass>(
      ps, L, Vec4Nodes<false>{reinterpret_cast<const float4*>(nodes)}, n_nodes,
      [&](const Ray& r) { return MatQuadLeaf(mat, (size_t)stride, r); }, ox, oy, oz, dx, dy, dz,
      n, gid_mask, t_min, t_max, t_out, prim_out, u_out, v_out, nx_out, ny_out, nz_out, counter);
}

using MatSceneClosestKernel = decltype(&mat_scene_closest_persistent<kMaxDepth4>);

// K10a's variants (ops/cuda/bvh_leafmat.scene_any_plan, as K10b's): one per
// depth class; nullptr for any other class.
inline MatSceneClosestKernel mat_scene_closest_variant(int depth_class) {
  if (depth_class == kShallow4) return mat_scene_closest_persistent<kShallow4>;
  if (depth_class == kMaxDepth4) return mat_scene_closest_persistent<kMaxDepth4>;
  return nullptr;
}

// K10b for Hopper: the sweep's verdict, else the walk's, for lanes [0, n)
// taken 32 at a time from `counter` (two int32, zero at the launch, left
// zero; finish_lanes).  Lanes with limit <= 0 are written occluded and read
// no ray.
template <int kClass>
__global__ void __launch_bounds__(kWalkThreads, 2)
mat_scene_any_persistent(const float* __restrict__ nodes, int n_nodes,
                         const float* __restrict__ mat, long long stride,
                         const float* __restrict__ ps_g, int P, int S, int Q,
                         const float* __restrict__ ox, const float* __restrict__ oy,
                         const float* __restrict__ oz, const float* __restrict__ dx,
                         const float* __restrict__ dy, const float* __restrict__ dz,
                         const float* __restrict__ limit_in, int n, float t_min,
                         uint8_t* __restrict__ occ_out, int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  const SceneLayout L = scene_layout(P, S, Q, 0);
  float* ps = reinterpret_cast<float*>(smem4);
  stage_blob(ps, ps_g, L.tb);
  const Vec4Nodes<false> src{reinterpret_cast<const float4*>(nodes)};
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    const float limit = limit_in[i];
    bool occ = limit <= 0.0f;
    if (!occ) {
      const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
      occ = any_hit(ps, L, r, t_min, limit);
      if (!occ) {
        LocalStack<stack_cap(kClass)> stack;
        occ = walk_any_with<false>(src, n_nodes, MatQuadLeaf(mat, (size_t)stride, r), stack, r,
                                   t_min, limit, nullptr);
      }
    }
    occ_out[i] = occ ? 1 : 0;
  }
  finish_lanes(counter);
}

using MatSceneAnyKernel = decltype(&mat_scene_any_persistent<kMaxDepth4>);

// K10b's variants (ops/cuda/bvh_leafmat.scene_any_plan): one per depth
// class; nullptr for any other class.
inline MatSceneAnyKernel mat_scene_any_variant(int depth_class) {
  if (depth_class == kShallow4) return mat_scene_any_persistent<kShallow4>;
  if (depth_class == kMaxDepth4) return mat_scene_any_persistent<kMaxDepth4>;
  return nullptr;
}

// K10c for Hopper: the carried record of lanes [0, n) through the whole
// tree, the lanes taken 32 at a time from `counter` (two int32, zero at the
// launch, left zero; finish_lanes).
template <int kClass>
__global__ void __launch_bounds__(kWalkThreads, 2)
mat_tri_closest_persistent(const float* __restrict__ nodes, int n_nodes,
                           const float* __restrict__ mat, long long stride, int gid_offset,
                           int gid_mask, const float* __restrict__ ox,
                           const float* __restrict__ oy, const float* __restrict__ oz,
                           const float* __restrict__ dx, const float* __restrict__ dy,
                           const float* __restrict__ dz, const float* __restrict__ t_in,
                           const int* __restrict__ prim_in, const float* __restrict__ u_in,
                           const float* __restrict__ v_in, const float* __restrict__ nx_in,
                           const float* __restrict__ ny_in, const float* __restrict__ nz_in,
                           int n, float t_min, float* __restrict__ t_out,
                           int* __restrict__ prim_out, float* __restrict__ u_out,
                           float* __restrict__ v_out, float* __restrict__ nx_out,
                           float* __restrict__ ny_out, float* __restrict__ nz_out,
                           int* __restrict__ counter) {
  const Vec4Nodes<false> src{reinterpret_cast<const float4*>(nodes)};
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
    Hit h;
    h.t = t_in[i]; h.prim = prim_in[i]; h.u = u_in[i]; h.v = v_in[i];
    h.nx = nx_in[i]; h.ny = ny_in[i]; h.nz = nz_in[i];
    LocalStack<stack_cap(kClass)> stack;
    walk_closest_with<false>(src, n_nodes, MatQuadLeaf(mat, (size_t)stride, r), stack, r, t_min,
                             gid_offset, h, nullptr);
    finish_hit(h, r, gid_offset, gid_mask);
    t_out[i] = h.t;
    prim_out[i] = h.prim;
    u_out[i] = h.u;
    v_out[i] = h.v;
    nx_out[i] = h.nx;
    ny_out[i] = h.ny;
    nz_out[i] = h.nz;
  }
  finish_lanes(counter);
}

using MatClosestKernel = decltype(&mat_tri_closest_persistent<kMaxDepth4>);

// K10c's variants (ops/cuda/bvh.depth_class): one per depth class; nullptr
// for any other class.
inline MatClosestKernel mat_closest_variant(int depth_class) {
  if (depth_class == kShallow4) return mat_tri_closest_persistent<kShallow4>;
  if (depth_class == kMaxDepth4) return mat_tri_closest_persistent<kMaxDepth4>;
  return nullptr;
}

// K10d for Hopper: the carried verdict, else the walk's, for lanes [0, n)
// taken 32 at a time from `counter` (two int32, zero at the launch, left
// zero; finish_lanes).  A found lane reads no ray.
template <int kClass>
__global__ void __launch_bounds__(kWalkThreads, 2)
mat_tri_any_persistent(const float* __restrict__ nodes, int n_nodes,
                       const float* __restrict__ mat, long long stride,
                       const float* __restrict__ ox, const float* __restrict__ oy,
                       const float* __restrict__ oz, const float* __restrict__ dx,
                       const float* __restrict__ dy, const float* __restrict__ dz,
                       const float* __restrict__ limit_in, const uint8_t* __restrict__ found_in,
                       int n, float t_min, uint8_t* __restrict__ found_out,
                       int* __restrict__ counter) {
  const Vec4Nodes<false> src{reinterpret_cast<const float4*>(nodes)};
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    bool found = found_in[i] != 0;
    if (!found) {
      const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
      LocalStack<stack_cap(kClass)> stack;
      found = walk_any_with<false>(src, n_nodes, MatQuadLeaf(mat, (size_t)stride, r), stack, r,
                                   t_min, limit_in[i], nullptr);
    }
    found_out[i] = found ? 1 : 0;
  }
  finish_lanes(counter);
}

using MatTriAnyKernel = decltype(&mat_tri_any_persistent<kMaxDepth4>);

// K10d's variants (ops/cuda/bvh_leafmat.tri_plan): one per depth class.
inline MatTriAnyKernel mat_tri_any_variant(int depth_class) {
  if (depth_class == kShallow4) return mat_tri_any_persistent<kShallow4>;
  if (depth_class == kMaxDepth4) return mat_tri_any_persistent<kMaxDepth4>;
  return nullptr;
}

}  // namespace ptrt

// The four launch entries launch on `stream`, allocate nothing and do not
// synchronise; each returns the launch's cudaError_t (0 when the launch was
// accepted).  `mat` is the (16, stride) table, stride = 128 · leaves.

// Resident blocks per SM of K10a's variant for depth_class with `smem` bytes
// of dynamic shared memory (the plane/sphere/quad blob), into *blocks; it
// stages no tree (stage must be 0).  First lifts the variant's dynamic
// shared memory limit to `smem` where it is lower.
extern "C" int ptrt_mat_scene_closest_occupancy(int stage, int depth_class, int smem,
                                                int* blocks) {
  return ptrt::table_occupancy(ptrt::mat_scene_closest_variant(depth_class), stage, smem, blocks);
}

// K10a: `grid` persistent blocks of the variant for depth_class with `smem`
// bytes of dynamic shared memory, which ptrt_mat_scene_closest_occupancy has
// sized and allowed, on the lane `counter` (two int32, zero at the launch
// and left zero); `nodes` and `mat` 16-byte aligned.
extern "C" int ptrt_mat_scene_closest(const float* nodes, int n_nodes, const float* mat,
                                      long long stride, const float* ps, int P, int S, int Q,
                                      const float* ox, const float* oy, const float* oz,
                                      const float* dx, const float* dy, const float* dz, int n,
                                      int gid_mask, float t_min, float t_max, float* t, int* prim,
                                      float* u, float* v, float* nx, float* ny, float* nz,
                                      int* counter, int depth_class, int smem, int grid,
                                      void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::MatSceneClosestKernel k = ptrt::mat_scene_closest_variant(depth_class);
  if (k == nullptr || (size_t)smem < ptrt::blob_bytes(P, S, Q))
    return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, smem, (cudaStream_t)stream>>>(
      nodes, n_nodes, mat, stride, ps, P, S, Q, ox, oy, oz, dx, dy, dz, n, gid_mask, t_min, t_max,
      t, prim, u, v, nx, ny, nz, counter);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of K10b's variant for depth_class with `smem` bytes
// of dynamic shared memory (the plane/sphere/quad blob), into *blocks; it
// stages no tree (stage must be 0).  First lifts the variant's dynamic
// shared memory limit to `smem` where it is lower.
extern "C" int ptrt_mat_scene_any_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::table_occupancy(ptrt::mat_scene_any_variant(depth_class), stage, smem, blocks);
}

// K10b: `grid` persistent blocks of the variant for depth_class with `smem`
// bytes of dynamic shared memory, which ptrt_mat_scene_any_occupancy has
// sized and allowed, on the lane `counter` (two int32, zero at the launch
// and left zero); `nodes` and `mat` 16-byte aligned.
extern "C" int ptrt_mat_scene_any(const float* nodes, int n_nodes, const float* mat,
                                  long long stride, const float* ps, int P, int S, int Q,
                                  const float* ox, const float* oy, const float* oz,
                                  const float* dx, const float* dy, const float* dz,
                                  const float* limit, int n, float t_min, uint8_t* occluded,
                                  int* counter, int depth_class, int smem, int grid,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::MatSceneAnyKernel k = ptrt::mat_scene_any_variant(depth_class);
  if (k == nullptr || (size_t)smem < ptrt::blob_bytes(P, S, Q))
    return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, smem, (cudaStream_t)stream>>>(
      nodes, n_nodes, mat, stride, ps, P, S, Q, ox, oy, oz, dx, dy, dz, limit, n, t_min,
      occluded, counter);
  return (int)cudaGetLastError();
}

// K10c: `grid` persistent blocks of the variant for depth_class, which
// ptrt_mat_tri_closest_occupancy has sized, on the lane `counter` (two
// int32, zero at the launch and left zero); `nodes` and `mat` 16-byte
// aligned.
extern "C" int ptrt_mat_tri_closest(const float* nodes, int n_nodes, const float* mat,
                                    long long stride, int gid_offset, int gid_mask,
                                    const float* ox, const float* oy, const float* oz,
                                    const float* dx, const float* dy, const float* dz,
                                    const float* t_in, const int* prim_in, const float* u_in,
                                    const float* v_in, const float* nx_in, const float* ny_in,
                                    const float* nz_in, int n, float t_min, float* t, int* prim,
                                    float* u, float* v, float* nx, float* ny, float* nz,
                                    int* counter, int depth_class, int grid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::MatClosestKernel k = ptrt::mat_closest_variant(depth_class);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, 0, (cudaStream_t)stream>>>(
      nodes, n_nodes, mat, stride, gid_offset, gid_mask, ox, oy, oz, dx, dy, dz, t_in, prim_in,
      u_in, v_in, nx_in, ny_in, nz_in, n, t_min, t, prim, u, v, nx, ny, nz, counter);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of K10c's variant for depth_class, into *blocks:
// it stages nothing (stage and smem must be 0).
extern "C" int ptrt_mat_tri_closest_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::walk_occupancy(ptrt::mat_closest_variant(depth_class), stage, smem, blocks);
}

// Resident blocks per SM of K10d's variant for depth_class, into *blocks:
// it stages nothing (stage and smem must be 0).
extern "C" int ptrt_mat_tri_any_occupancy(int stage, int depth_class, int smem, int* blocks) {
  return ptrt::walk_occupancy(ptrt::mat_tri_any_variant(depth_class), stage, smem, blocks);
}

// K10d: `grid` persistent blocks of the variant for depth_class, which
// ptrt_mat_tri_any_occupancy has sized, on the lane `counter` (as K10c's);
// `nodes` and `mat` 16-byte aligned.
extern "C" int ptrt_mat_tri_any(const float* nodes, int n_nodes, const float* mat,
                                long long stride, const float* ox, const float* oy,
                                const float* oz, const float* dx, const float* dy, const float* dz,
                                const float* limit, const uint8_t* found_in, int n, float t_min,
                                uint8_t* found, int* counter, int depth_class, int grid,
                                void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::MatTriAnyKernel k = ptrt::mat_tri_any_variant(depth_class);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, 0, (cudaStream_t)stream>>>(
      nodes, n_nodes, mat, stride, ox, oy, oz, dx, dy, dz, limit, found_in, n, t_min, found,
      counter);
  return (int)cudaGetLastError();
}
