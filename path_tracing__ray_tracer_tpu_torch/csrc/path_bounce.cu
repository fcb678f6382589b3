// One whole path-tracer bounce, one ray per thread.
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
// What bounds it: arithmetic and latency, not bytes.  Per ray it reads about
// 44 B (origin, direction, throughput, key, depth) and writes 76 B (the
// 19-field record) plus the 4 B winner id, against two sweeps over the
// scene's primitives (22 on the Cornell box) and some 40 branches of shading.
// Its one design choice: the scene (primitive blob, material table, light
// samples; about 2.4 KB for the Cornell box) is copied into shared memory at
// block start, so every primitive read is a broadcast to the warp.
//
// Output: the (19, N) record of path_shade.cuh, the field order of
// path_bounce_pallas' outputs, plus `prim` (N,) int32, the winning global
// primitive id (-1 on miss).
//
// The shading after the hit is csrc/path_shade.cuh, shared with K5.
#include <cuda_runtime.h>

#include <cstdint>

#include "path_shade.cuh"
#include "sweep.cuh"

namespace ptrt {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
path_bounce_kernel(const float* __restrict__ blob_g, int P, int S, int Q, int T,
                   const float* __restrict__ mat_g, int n_mats,
                   const float* __restrict__ light_g, int n_lights,
                   const int* __restrict__ depth_in,
                   const float* __restrict__ ox_in, const float* __restrict__ oy_in,
                   const float* __restrict__ oz_in, const float* __restrict__ dx_in,
                   const float* __restrict__ dy_in, const float* __restrict__ dz_in,
                   const float* __restrict__ tx_in, const float* __restrict__ ty_in,
                   const float* __restrict__ tz_in, const int* __restrict__ key_in,
                   float* __restrict__ out, int* __restrict__ prim_out, int n,
                   float t_min, float t_max, int shadow_light) {
  extern __shared__ float smem[];
  const SceneLayout L = scene_layout(P, S, Q, T);
  const int blob_size = L.tb + 18 * T;
  const int mat_size = kMatFields * n_mats;
  const int total = blob_size + mat_size + 3 * n_lights;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    smem[k] = k < blob_size ? blob_g[k]
              : k < blob_size + mat_size ? mat_g[k - blob_size]
                                         : light_g[k - blob_size - mat_size];
  }
  __syncthreads();
  const float* blob = smem;
  const float* mat = smem + blob_size;
  const float* light = mat + mat_size;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged tail

  const uint32_t depth = (uint32_t)depth_in[i];
  const uint32_t key = (uint32_t)key_in[i];
  Ray r;
  r.ox = ox_in[i]; r.oy = oy_in[i]; r.oz = oz_in[i];
  r.dx = dx_in[i]; r.dy = dy_in[i]; r.dz = dz_in[i];

  // ---- closest hit with carried attributes, the winner's material ----------
  const Hit h = closest_hit(blob, L, r, t_min, t_max);
  const Surface s{h.prim >= 0, r.ox + r.dx * h.t, r.oy + r.dy * h.t, r.oz + r.dz * h.t,
                  h.nx, h.ny, h.nz, h.u, h.v};
  const Material m = s.hit ? material_row(mat, n_mats, h.prim) : miss_material();

  // ---- NEE: uniform light pick + shadow sweep to the first occluder --------
  const ShadowQuery q = nee_query(light, n_lights, key, depth, s, m, t_max, shadow_light);
  const float w_nee = q.care && !any_hit(blob, L, q.ray, t_min, q.bound) ? q.w : 0.0f;

  scatter_write(out, n, i, key, depth, r, tx_in[i], ty_in[i], tz_in[i], s, m, w_nee);
  prim_out[i] = h.prim;
}

}  // namespace ptrt

// Launches on `stream`; allocates nothing and does not synchronise.  Returns
// the launch's cudaError_t (0 when the launch was accepted).
extern "C" int ptrt_path_bounce(const float* blob, int P, int S, int Q, int T,
                                const float* mat, int n_mats, const float* lights,
                                int n_lights, const int* depth, const float* ox,
                                const float* oy, const float* oz, const float* dx,
                                const float* dy, const float* dz, const float* tx,
                                const float* ty, const float* tz, const int* key,
                                float* out, int* prim, int n, float t_min, float t_max,
                                int shadow_light, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blob_size = 14 * P + 4 * S + 18 * Q + 18 * T;
  const size_t smem = sizeof(float) * (size_t)(blob_size + ptrt::kMatFields * n_mats + 3 * n_lights);
  const int blocks = (n + ptrt::kThreads - 1) / ptrt::kThreads;
  ptrt::path_bounce_kernel<<<blocks, ptrt::kThreads, smem, (cudaStream_t)stream>>>(
      blob, P, S, Q, T, mat, n_mats, lights, n_lights, depth, ox, oy, oz, dx, dy, dz, tx, ty,
      tz, key, out, prim, n, t_min, t_max, shadow_light);
  return (int)cudaGetLastError();
}
