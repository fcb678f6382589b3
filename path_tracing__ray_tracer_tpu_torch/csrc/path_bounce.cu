// One whole path-tracer bounce, one ray per thread, in persistent blocks.
//
// Replaces the JAX package's ops/pallas/bounce_pallas.py::_path_bounce_kernel
// (entered there through path_bounce_pallas): the closest-hit sweep with
// attributes, the winner's material record, next-event estimation (uniform
// light pick + shadow sweep), Russian roulette from depth 3, the 60/25/15
// glass event with the TIR fallback, and the mirror / cosine-hemisphere
// scatter.  It emits the shading-weight record, not a colour: the base colour
// (atlas texel or material colour) enters only multiplicatively, and the
// caller applies
//     radiance += thr * (w_sky + base * w_nee)
//     thr      *= rr_scale * (s_thr + base * t_thr)
//
// What bounds it: issue slots and latency, not bytes.  Per ray it reads about
// 44 B (origin, direction, throughput, key, depth) and writes 76 B (the
// 19-field record) plus the 4 B winner id, against two sweeps over the
// scene's primitives (22 on the Cornell box) and some 40 branches of shading.
// The design for Hopper:
//   * each resident block copies the scene into shared memory once, the
//     primitives as primitive-major 16-byte records (sweep.cuh
//     stage_records; closest_hit16 / any_hit16: a primitive test issues 1-4
//     LDS.128 where the field-major blob took 4-18 scalar loads), then the
//     material table and light samples;
//   * the blocks are persistent: only the resident ones launch; each warp
//     takes its first 32 lanes by its place in the grid and its later ones
//     32 at a time from the stream's lane counter (bvh_walk.cuh next_batch /
//     finish_lanes), so the copy runs once per resident block, and a launch
//     whose resident blocks cover its lanes touches no counter;
//   * the record is written with w_nee (field 3) 0 before the NEE shadow
//     sweep, and w_nee rewritten with the weight when the ray comes back
//     unoccluded, so the shading state is dead during the sweep (64
//     registers, 4 resident blocks an SM, where it held 72 and 3).
// The NEE shadow rays are not compacted across a warp's lanes or batches: a
// variant that queued them per warp in shared memory and swept them 32 at a
// time took 1.02-1.04x this one's device time on the main path's first
// chunk (PERF.md).
// Every lane's arithmetic is the first design's (git 80edfcd), expression
// for expression, so the record is the same bits.
//
// Output: the (19, N) record of path_shade.cuh, the field order of
// path_bounce_pallas' outputs, plus `prim` (N,) int32, the winning global
// primitive id (-1 on miss).
//
// The shading after the hit is csrc/path_shade.cuh, shared with K5 and K7.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "path_shade.cuh"
#include "sweep.cuh"

namespace ptrt {

constexpr int kThreads = kWalkThreads;

__global__ void __launch_bounds__(kThreads)
path_bounce_persistent(const float* __restrict__ blob_g, int P, int S, int Q, int T,
                       const float* __restrict__ mat_g, int n_mats,
                       const float* __restrict__ light_g, int n_lights,
                       const int* __restrict__ depth_in, const float* __restrict__ ox_in,
                       const float* __restrict__ oy_in, const float* __restrict__ oz_in,
                       const float* __restrict__ dx_in, const float* __restrict__ dy_in,
                       const float* __restrict__ dz_in, const float* __restrict__ tx_in,
                       const float* __restrict__ ty_in, const float* __restrict__ tz_in,
                       const int* __restrict__ key_in, float* __restrict__ out,
                       int* __restrict__ prim_out, int n, float t_min, float t_max,
                       int shadow_light, int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  const SceneLayout L = scene_layout(P, S, Q, T);
  const RecLayout R = rec_layout(P, S, Q, T);
  float* smem = reinterpret_cast<float*>(smem4);
  stage_records(smem, blob_g, L, R);
  float* mat = smem + mat_offset(R);
  float* light = smem + light_offset(R, kMatFields * n_mats);  // field-major, as nee_query reads
  for (int k = threadIdx.x; k < kMatFields * n_mats; k += blockDim.x) mat[k] = mat_g[k];
  for (int k = threadIdx.x; k < 3 * n_lights; k += blockDim.x) light[k] = light_g[k];
  __syncthreads();
  const float4* rec = smem4;

  const int lane = threadIdx.x & 31;
  const int span = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;; i = next_batch(counter, span, n)) {
    if (i - lane >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    const uint32_t depth = (uint32_t)depth_in[i];
    const uint32_t key = (uint32_t)key_in[i];
    Ray r;
    r.ox = ox_in[i]; r.oy = oy_in[i]; r.oz = oz_in[i];
    r.dx = dx_in[i]; r.dy = dy_in[i]; r.dz = dz_in[i];

    // ---- closest hit with carried attributes, the winner's material --------
    const Hit h = closest_hit16(rec, R, r, t_min, t_max);
    const Surface s{h.prim >= 0, r.ox + r.dx * h.t, r.oy + r.dy * h.t, r.oz + r.dz * h.t,
                    h.nx, h.ny, h.nz, h.u, h.v};
    const Material m = s.hit ? material_row(mat, n_mats, h.prim) : miss_material();

    // ---- NEE query; the record with w_nee 0, then its weight when the shadow
    // ray comes back unoccluded (the first occluder ends its sweep) ---------
    const ShadowQuery q = nee_query(light, n_lights, key, depth, s, m, t_max, shadow_light);
    scatter_write(out, n, i, key, depth, r, tx_in[i], ty_in[i], tz_in[i], s, m, 0.0f);
    prim_out[i] = h.prim;
    if (q.care && !any_hit16(rec, R, q.ray, t_min, q.bound)) out[3 * (size_t)n + i] = q.w;
  }
  if (span < n) finish_lanes(counter);
}

}  // namespace ptrt

// Resident blocks per SM with `smem` bytes of dynamic shared memory, into
// *blocks; first lifts the kernel's dynamic shared memory limit to `smem`
// where it is lower.
extern "C" int ptrt_path_bounce_occupancy(int smem, int* blocks) {
  cudaError_t err = ptrt::allow_smem(ptrt::path_bounce_persistent, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ptrt::path_bounce_persistent,
                                                        ptrt::kThreads, smem);
  return (int)err;
}

// `grid` persistent blocks with `smem` bytes of dynamic shared memory, which
// ptrt_path_bounce_occupancy has allowed; `counter` is two int32 of scratch,
// zero at the launch and left zero by the kernel.  Launches on `stream`;
// allocates nothing and does not synchronise.  Returns the launch's
// cudaError_t (0 when the launch was accepted).
extern "C" int ptrt_path_bounce(const float* blob, int P, int S, int Q, int T,
                                const float* mat, int n_mats, const float* lights,
                                int n_lights, const int* depth, const float* ox,
                                const float* oy, const float* oz, const float* dx,
                                const float* dy, const float* dz, const float* tx,
                                const float* ty, const float* tz, const int* key,
                                float* out, int* prim, int n, float t_min, float t_max,
                                int shadow_light, int* counter, int smem, int grid,
                                void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((size_t)smem < ptrt::bounce_smem_bytes(P, S, Q, T, n_mats, n_lights))
    return (int)cudaErrorInvalidValue;
  ptrt::path_bounce_persistent<<<grid, ptrt::kThreads, smem, (cudaStream_t)stream>>>(
      blob, P, S, Q, T, mat, n_mats, lights, n_lights, depth, ox, oy, oz, dx, dy, dz, tx, ty,
      tz, key, out, prim, n, t_min, t_max, shadow_light, counter);
  return (int)cudaGetLastError();
}
