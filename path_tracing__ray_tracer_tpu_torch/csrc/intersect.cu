// Standalone brute-force intersection, one ray per thread: the closest hit
// with its attributes, and the any-hit occlusion test with a per-ray bound.
//
// Replaces the JAX package's ops/pallas/intersect_pallas.py::_closest_kernel
// (entered there through closest_hit_pallas) and ::_any_kernel (entered
// through any_hit_pallas).  Both sweep bodies are sweep.cuh's closest_hit /
// any_hit, the ones the bounce kernels use.
//
// What bounds them: operations and latency, not bytes.  closest_hit reads
// 24 B per ray and writes 28 B, against a full sweep of about 30-45 float
// operations per primitive (22 primitives on the Cornell box); any_hit
// reads 28 B and writes 1 B, and stops at the first occluder.  The scene
// blob (1.3 KB for the Cornell box) is copied into shared memory at block
// start, so every primitive read is a broadcast to the warp.
//
// Outputs of closest_hit: t (the bound on a miss), prim (int32, -1 on a
// miss), the shading normal (zeros on a miss), u, v (zeros on a miss).
// Output of any_hit: one byte per ray, 1 when occluded in (t_min, t_max[i]).
#include <cuda_runtime.h>

#include <cstdint>

#include "sweep.cuh"

namespace ptrt {

constexpr int kIsectThreads = 256;

__device__ __forceinline__ void stage_blob(float* smem, const float* __restrict__ blob_g,
                                           int size) {
  for (int k = threadIdx.x; k < size; k += blockDim.x) smem[k] = blob_g[k];
  __syncthreads();
}

__global__ void __launch_bounds__(kIsectThreads)
closest_kernel(const float* __restrict__ blob_g, int P, int S, int Q, int T,
               const float* __restrict__ ox_in, const float* __restrict__ oy_in,
               const float* __restrict__ oz_in, const float* __restrict__ dx_in,
               const float* __restrict__ dy_in, const float* __restrict__ dz_in, int n,
               float t_min, float t_max, float* __restrict__ t_out, int* __restrict__ prim_out,
               float* __restrict__ nx_out, float* __restrict__ ny_out,
               float* __restrict__ nz_out, float* __restrict__ u_out,
               float* __restrict__ v_out) {
  extern __shared__ float smem[];
  const SceneLayout L = scene_layout(P, S, Q, T);
  stage_blob(smem, blob_g, L.tb + 18 * T);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged tail
  Ray r;
  r.ox = ox_in[i]; r.oy = oy_in[i]; r.oz = oz_in[i];
  r.dx = dx_in[i]; r.dy = dy_in[i]; r.dz = dz_in[i];
  const Hit h = closest_hit(smem, L, r, t_min, t_max);
  t_out[i] = h.t;
  prim_out[i] = h.prim;
  nx_out[i] = h.nx;
  ny_out[i] = h.ny;
  nz_out[i] = h.nz;
  u_out[i] = h.u;
  v_out[i] = h.v;
}

__global__ void __launch_bounds__(kIsectThreads)
any_kernel(const float* __restrict__ blob_g, int P, int S, int Q, int T,
           const float* __restrict__ ox_in, const float* __restrict__ oy_in,
           const float* __restrict__ oz_in, const float* __restrict__ dx_in,
           const float* __restrict__ dy_in, const float* __restrict__ dz_in,
           const float* __restrict__ tmax_in, int n, float t_min,
           uint8_t* __restrict__ occ_out) {
  extern __shared__ float smem[];
  const SceneLayout L = scene_layout(P, S, Q, T);
  stage_blob(smem, blob_g, L.tb + 18 * T);

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = ox_in[i]; r.oy = oy_in[i]; r.oz = oz_in[i];
  r.dx = dx_in[i]; r.dy = dy_in[i]; r.dz = dz_in[i];
  occ_out[i] = any_hit(smem, L, r, t_min, tmax_in[i]) ? 1 : 0;
}

inline size_t blob_bytes(int P, int S, int Q, int T) {
  return sizeof(float) * (size_t)(14 * P + 4 * S + 18 * Q + 18 * T);
}

}  // namespace ptrt

// Both launch on `stream`, allocate nothing and do not synchronise.  Each
// returns the launch's cudaError_t (0 when the launch was accepted).
extern "C" int ptrt_closest_hit(const float* blob, int P, int S, int Q, int T, const float* ox,
                                const float* oy, const float* oz, const float* dx,
                                const float* dy, const float* dz, int n, float t_min,
                                float t_max, float* t, int* prim, float* nx, float* ny,
                                float* nz, float* u, float* v, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + ptrt::kIsectThreads - 1) / ptrt::kIsectThreads;
  ptrt::closest_kernel<<<blocks, ptrt::kIsectThreads, ptrt::blob_bytes(P, S, Q, T),
                         (cudaStream_t)stream>>>(blob, P, S, Q, T, ox, oy, oz, dx, dy, dz, n,
                                                 t_min, t_max, t, prim, nx, ny, nz, u, v);
  return (int)cudaGetLastError();
}

extern "C" int ptrt_any_hit(const float* blob, int P, int S, int Q, int T, const float* ox,
                            const float* oy, const float* oz, const float* dx, const float* dy,
                            const float* dz, const float* t_max, int n, float t_min,
                            uint8_t* occluded, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + ptrt::kIsectThreads - 1) / ptrt::kIsectThreads;
  ptrt::any_kernel<<<blocks, ptrt::kIsectThreads, ptrt::blob_bytes(P, S, Q, T),
                     (cudaStream_t)stream>>>(blob, P, S, Q, T, ox, oy, oz, dx, dy, dz, t_max, n,
                                             t_min, occluded);
  return (int)cudaGetLastError();
}
