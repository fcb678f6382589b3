// Standalone brute-force intersection, one ray per thread, in persistent
// blocks: the closest hit with its attributes, and the any-hit occlusion
// test with a per-ray bound.
//
// Replaces the JAX package's ops/pallas/intersect_pallas.py::_closest_kernel
// (entered there through closest_hit_pallas) and ::_any_kernel (entered
// through any_hit_pallas).  The oracle renderer (models/whitted_oracle.py)
// launches them: per level of its fork recursion one closest-hit launch over
// the level's rays, and one any-hit launch over the shadow rays of all its
// rays and all light samples (16 x the level's rays on the Cornell box).
//
// What bounds them: operations and latency, not bytes.  closest_hit reads
// 24 B per ray and writes 28 B, against a full sweep of about 30-45 float
// operations per primitive (22 primitives on the Cornell box); any_hit
// reads 28 B and writes 1 B, and stops at the first occluder.  Built with
// --fmad=false, every multiply and every add issues on its own.
// The design for Hopper (K1's and K2's, csrc/path_bounce.cu):
//   * each resident block copies the scene into shared memory once, as
//     primitive-major 16-byte records (sweep.cuh stage_records), and sweeps
//     them with closest_hit16 / any_hit16: a primitive test issues 1-4
//     LDS.128 where the field-major blob took 4-18 scalar loads;
//   * the blocks are persistent: only the resident ones launch (the grid
//     from the occupancy entries below); each warp takes its first 32 lanes
//     by its place in the grid and its later ones 32 at a time from the
//     stream's lane counter (bvh_walk.cuh next_batch / finish_lanes), so the
//     copy runs once per resident block, however many lanes the launch has
//     (the oracle's shadow batch of 4,194,304 rays took 16,384 copies in the
//     first design), and a launch whose resident blocks cover its lanes
//     touches no counter.
// Every lane's arithmetic is the first design's (git 5f6caf2: one block of
// 256 per 256 rays, the field-major sweeps closest_hit / any_hit), expression
// for expression and in the same primitive order, so every output is the
// same bits; the any-hit sweep stops at the same primitive.
//
// Outputs of closest_hit: t (the bound on a miss), prim (int32, -1 on a
// miss), the shading normal (zeros on a miss), u, v (zeros on a miss).
// Output of any_hit: one byte per ray, 1 when occluded in (t_min, t_max[i]).
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "sweep.cuh"

namespace ptrt {

constexpr int kIsectThreads = kWalkThreads;  // table_occupancy sizes blocks of kWalkThreads

// Copy the blob's primitives into the block's records and wait for them.
__device__ __forceinline__ const float4* stage_scene(float4* smem4,
                                                     const float* __restrict__ blob_g, int P,
                                                     int S, int Q, int T, RecLayout& R) {
  const SceneLayout L = scene_layout(P, S, Q, T);
  R = rec_layout(P, S, Q, T);
  stage_records(reinterpret_cast<float*>(smem4), blob_g, L, R);
  __syncthreads();
  return smem4;
}

__global__ void __launch_bounds__(kIsectThreads)
closest_hit_persistent(const float* __restrict__ blob_g, int P, int S, int Q, int T,
                       const float* __restrict__ ox_in, const float* __restrict__ oy_in,
                       const float* __restrict__ oz_in, const float* __restrict__ dx_in,
                       const float* __restrict__ dy_in, const float* __restrict__ dz_in, int n,
                       float t_min, float t_max, float* __restrict__ t_out,
                       int* __restrict__ prim_out, float* __restrict__ nx_out,
                       float* __restrict__ ny_out, float* __restrict__ nz_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  RecLayout R;
  const float4* rec = stage_scene(smem4, blob_g, P, S, Q, T, R);

  const int lane = threadIdx.x & 31;
  const int span = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;; i = next_batch(counter, span, n)) {
    if (i - lane >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;      // ragged tail
    const Ray r = load_ray(ox_in, oy_in, oz_in, dx_in, dy_in, dz_in, i);
    const Hit h = closest_hit16(rec, R, r, t_min, t_max);
    t_out[i] = h.t;
    prim_out[i] = h.prim;
    nx_out[i] = h.nx;
    ny_out[i] = h.ny;
    nz_out[i] = h.nz;
    u_out[i] = h.u;
    v_out[i] = h.v;
  }
  if (span < n) finish_lanes(counter);
}

__global__ void __launch_bounds__(kIsectThreads)
any_hit_persistent(const float* __restrict__ blob_g, int P, int S, int Q, int T,
                   const float* __restrict__ ox_in, const float* __restrict__ oy_in,
                   const float* __restrict__ oz_in, const float* __restrict__ dx_in,
                   const float* __restrict__ dy_in, const float* __restrict__ dz_in,
                   const float* __restrict__ tmax_in, int n, float t_min,
                   uint8_t* __restrict__ occ_out, int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  RecLayout R;
  const float4* rec = stage_scene(smem4, blob_g, P, S, Q, T, R);

  const int lane = threadIdx.x & 31;
  const int span = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;; i = next_batch(counter, span, n)) {
    if (i - lane >= n) break;
    if (i >= n) continue;
    const Ray r = load_ray(ox_in, oy_in, oz_in, dx_in, dy_in, dz_in, i);
    occ_out[i] = any_hit16(rec, R, r, t_min, tmax_in[i]) ? 1 : 0;
  }
  if (span < n) finish_lanes(counter);
}

// The records' bytes in shared memory.
inline size_t records_bytes(int P, int S, int Q, int T) {
  return sizeof(float4) * (size_t)rec_layout(P, S, Q, T).size4;
}

}  // namespace ptrt

// Resident blocks per SM with `smem` bytes of dynamic shared memory, into
// *blocks; first lifts the kernel's dynamic shared memory limit to `smem`
// where it is lower.
extern "C" int ptrt_closest_hit_occupancy(int smem, int* blocks) {
  return ptrt::table_occupancy(ptrt::closest_hit_persistent, 0, smem, blocks);
}

extern "C" int ptrt_any_hit_occupancy(int smem, int* blocks) {
  return ptrt::table_occupancy(ptrt::any_hit_persistent, 0, smem, blocks);
}

// Both launch `grid` persistent blocks with `smem` bytes of dynamic shared
// memory, which their occupancy entry has allowed; `counter` is two int32 of
// scratch, zero at the launch and left zero by the kernel.  Both launch on
// `stream`, allocate nothing and do not synchronise.  Each returns the
// launch's cudaError_t (0 when the launch was accepted).
extern "C" int ptrt_closest_hit(const float* blob, int P, int S, int Q, int T, const float* ox,
                                const float* oy, const float* oz, const float* dx,
                                const float* dy, const float* dz, int n, float t_min,
                                float t_max, float* t, int* prim, float* nx, float* ny,
                                float* nz, float* u, float* v, int* counter, int smem, int grid,
                                void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((size_t)smem < ptrt::records_bytes(P, S, Q, T)) return (int)cudaErrorInvalidValue;
  ptrt::closest_hit_persistent<<<grid, ptrt::kIsectThreads, smem, (cudaStream_t)stream>>>(
      blob, P, S, Q, T, ox, oy, oz, dx, dy, dz, n, t_min, t_max, t, prim, nx, ny, nz, u, v,
      counter);
  return (int)cudaGetLastError();
}

extern "C" int ptrt_any_hit(const float* blob, int P, int S, int Q, int T, const float* ox,
                            const float* oy, const float* oz, const float* dx, const float* dy,
                            const float* dz, const float* t_max, int n, float t_min,
                            uint8_t* occluded, int* counter, int smem, int grid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((size_t)smem < ptrt::records_bytes(P, S, Q, T)) return (int)cudaErrorInvalidValue;
  ptrt::any_hit_persistent<<<grid, ptrt::kIsectThreads, smem, (cudaStream_t)stream>>>(
      blob, P, S, Q, T, ox, oy, oz, dx, dy, dz, t_max, n, t_min, occluded, counter);
  return (int)cudaGetLastError();
}
