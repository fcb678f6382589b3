// One whole path-tracer bounce on a BVH scene, one ray per thread (K5).
//
// Replaces the JAX package's ops/pallas/bounce_bvh_pallas.py::
// _path_bounce_bvh_kernel (entered there through path_bounce_bvh_pallas)
// in its shipped split form (BVH_BOUNCE_SPLIT_ANY): the closest hit (the
// plane/sphere/quad sweep seeding the BVH4 walk of bvh_walk.cuh), the
// winner's material from the unique-material table, NEE preparation, Russian
// roulette and the scatter of path_shade.cuh.  The shadow query is not
// answered here: each lane emits its shadow ray, which K4b
// (bvh_scene.cu's bvh_any_kernel) answers in a second launch; the caller
// zeroes w_nee where it is occluded.
//
// The material needs no per-primitive table: a triangle winner's slot gid
// carries its unique-material id (uid << 17 | tri), and the few
// non-triangle primitives map to theirs through `psuid`.  Triangle UVs are
// 0: the caller takes this kernel only when no textured triangle reads them.
//
// What bounds it: latency, as K4a (one walk per ray from device memory);
// the shading adds about 60 float operations.  Per ray it reads 44 B and
// writes 76 B of record, 4 B of prim and 28 B of shadow ray.
//
// Outputs: the (19, N) record of path_shade.cuh with w_nee not yet masked by
// occlusion (0 where its answer is not needed); `prim` (N,) int32; the
// shadow record (7, N): origin, direction, limit (-1 where no answer is
// needed, which K4b reports as occluded).
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "path_shade.cuh"
#include "sweep.cuh"

namespace ptrt {

constexpr int kBvhBounceThreads = 128;

__global__ void __launch_bounds__(kBvhBounceThreads)
path_bounce_bvh_kernel(const float* __restrict__ nodes, int n_nodes,
                       const float* __restrict__ slots, const float* __restrict__ ps_g, int P,
                       int S, int Q, const float* __restrict__ psuid_g,
                       const float* __restrict__ umat_g, int n_umats,
                       const float* __restrict__ light_g, int n_lights,
                       const int* __restrict__ depth_in, const float* __restrict__ ox_in,
                       const float* __restrict__ oy_in, const float* __restrict__ oz_in,
                       const float* __restrict__ dx_in, const float* __restrict__ dy_in,
                       const float* __restrict__ dz_in, const float* __restrict__ tx_in,
                       const float* __restrict__ ty_in, const float* __restrict__ tz_in,
                       const int* __restrict__ key_in, float* __restrict__ out,
                       int* __restrict__ prim_out, float* __restrict__ shadow_out, int n,
                       float t_min, float t_max, int shadow_light) {
  extern __shared__ float smem[];
  const SceneLayout L = scene_layout(P, S, Q, 0);
  const int off = P + S + Q;
  const int umat_size = kMatFields * n_umats;
  const int total = L.tb + off + umat_size + 3 * n_lights;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    smem[k] = k < L.tb ? ps_g[k]
              : k < L.tb + off ? psuid_g[k - L.tb]
              : k < L.tb + off + umat_size ? umat_g[k - L.tb - off]
                                           : light_g[k - L.tb - off - umat_size];
  }
  __syncthreads();
  const float* ps = smem;
  const float* psuid = ps + L.tb;
  const float* umat = psuid + off;
  const float* light = umat + umat_size;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged tail

  const uint32_t depth = (uint32_t)depth_in[i];
  const uint32_t key = (uint32_t)key_in[i];
  Ray r;
  r.ox = ox_in[i]; r.oy = oy_in[i]; r.oz = oz_in[i];
  r.dx = dx_in[i]; r.dy = dy_in[i]; r.dz = dz_in[i];

  // ---- closest hit: the plane/sphere/quad sweep seeds the BVH4 walk -------
  Hit h = closest_hit(ps, L, r, t_min, t_max);
  walk_closest(nodes, n_nodes, slots, r, t_min, off, h);
  const bool is_tri = h.prim >= off;
  int uid = h.prim >= 0 ? (int)psuid[h.prim < off ? h.prim : 0] : -1;
  if (is_tri) {
    uid = (h.prim - off) >> kGidUidBits;
    const float sgn = h.nx * r.dx + h.ny * r.dy + h.nz * r.dz > 0.0f ? -1.0f : 1.0f;
    h.nx = h.nx * sgn; h.ny = h.ny * sgn; h.nz = h.nz * sgn;
  }
  const Surface s{h.prim >= 0, r.ox + r.dx * h.t, r.oy + r.dy * h.t, r.oz + r.dz * h.t,
                  h.nx, h.ny, h.nz, is_tri ? 0.0f : h.u, is_tri ? 0.0f : h.v};
  const Material m = uid >= 0 ? material_row(umat, n_umats, uid) : miss_material();

  // ---- NEE: the shadow ray goes out for K4b; w_nee is masked afterwards ----
  const ShadowQuery q = nee_query(light, n_lights, key, depth, s, m, t_max, shadow_light);
  float* so = shadow_out + i;
  const size_t N = (size_t)n;
  so[0 * N] = q.ray.ox;
  so[1 * N] = q.ray.oy;
  so[2 * N] = q.ray.oz;
  so[3 * N] = q.ray.dx;
  so[4 * N] = q.ray.dy;
  so[5 * N] = q.ray.dz;
  so[6 * N] = q.care ? q.bound : -1.0f;

  scatter_write(out, n, i, key, depth, r, tx_in[i], ty_in[i], tz_in[i], s, m,
                q.care ? q.w : 0.0f);
  prim_out[i] = decode_prim(h.prim, off);
}

}  // namespace ptrt

// Launches on `stream`; allocates nothing and does not synchronise.  Returns
// the launch's cudaError_t (0 when the launch was accepted).
extern "C" int ptrt_path_bounce_bvh(const float* nodes, int n_nodes, const float* slots,
                                    const float* ps, int P, int S, int Q, const float* psuid,
                                    const float* umat, int n_umats, const float* lights,
                                    int n_lights, const int* depth, const float* ox,
                                    const float* oy, const float* oz, const float* dx,
                                    const float* dy, const float* dz, const float* tx,
                                    const float* ty, const float* tz, const int* key,
                                    float* out, int* prim, float* shadow, int n, float t_min,
                                    float t_max, int shadow_light, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int off = P + S + Q;
  const size_t smem = sizeof(float) * (size_t)(14 * P + 4 * S + 18 * Q + off +
                                               ptrt::kMatFields * n_umats + 3 * n_lights);
  const int blocks = (n + ptrt::kBvhBounceThreads - 1) / ptrt::kBvhBounceThreads;
  ptrt::path_bounce_bvh_kernel<<<blocks, ptrt::kBvhBounceThreads, smem, (cudaStream_t)stream>>>(
      nodes, n_nodes, slots, ps, P, S, Q, psuid, umat, n_umats, lights, n_lights, depth, ox, oy,
      oz, dx, dy, dz, tx, ty, tz, key, out, prim, shadow, n, t_min, t_max, shadow_light);
  return (int)cudaGetLastError();
}
