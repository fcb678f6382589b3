// One whole Whitted bounce, one ray per thread, in persistent blocks.
//
// Replaces the JAX package's ops/pallas/whitted_pallas.py::_whitted_bounce_kernel
// (entered there through whitted_bounce_pallas): the closest-hit sweep with
// attributes, the winner's material record, ambient plus one Lambert/Phong
// term per area-light sample with its shadow sweep (per-ray bound
// dist - 1e-3), the energy factor, and the reflect/refract continuation.  It
// emits the shading-weight record, not a colour; the caller applies
//     color += atten * (base * a + w)
//     atten *= mult   (where cont)
//
// What bounds it: operations and latency, not bytes.  Per ray it reads 24 B
// and writes 72 B, against one closest sweep and up to n_lights (16 on the
// Cornell box) shadow sweeps over the scene's primitives, about 30-45 float
// operations per primitive test.  A shadow sweep stops at its first occluder
// and is skipped for a light whose Lambert and Phong terms are both exactly
// zero whatever the occlusion (`care` false: a miss, the light behind the
// surface, a black material), since adding 0 leaves the sums as they were.
// The design for Hopper:
//   * each resident block copies the scene into shared memory once, the
//     primitives as primitive-major 16-byte records (sweep.cuh
//     stage_records; closest_hit16 / any_hit16: a primitive test issues 1-4
//     LDS.128 where the field-major blob took 4-18 scalar loads), then the
//     material table and the light samples as float4s;
//   * the blocks are persistent: only the resident ones launch; each warp
//     takes its first 32 lanes by its place in the grid and its later ones
//     32 at a time from the stream's lane counter (bvh_walk.cuh next_batch /
//     finish_lanes), so a warp of misses takes its next batch while a warp
//     of lit hits still sweeps;
//   * a miss skips the light loop (its `care` is false for every light), and
//     the fields the loop does not need are written before it.
// The shadow sweeps are not compacted across a warp's lanes: on the Cornell
// box a lane that hits cares about every one of its 16 light samples, so a
// warp's shadow sweeps are its hit lanes' anyway; a variant that queued the
// (lane, light) pairs and swept them one a thread measured 1.05-1.23x this
// one's device time (PERF.md).
// Every lane's arithmetic is the first design's (git 80edfcd), expression
// for expression, so the record is the same bits.
//
// Output record, row-major (17, N) float32, the field order of
// whitted_bounce_pallas' outputs:
//   0 hit  1 a  2 w  3 cont  4 mult  5-7 new origin  8-10 new direction
//   11 u  12 v  13 tex_id (-1 untextured)  14-16 material colour
// plus `prim` (N,) int32, the winning global primitive id (-1 on miss).
// Miss lanes carry the kernel's convention: zero material, ior 1, tex -1.
//
// Arithmetic keeps the JAX kernel's association (built with --fmad=false),
// constants folded in double as Python folds them.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "sweep.cuh"

namespace ptrt {

constexpr int kWhittedThreads = kWalkThreads;
constexpr int kWMatFields = 10;  // r g b diffuse specular reflective refractive ior has_tex tex_id
constexpr float kWEps = 1e-3f;

struct WhittedSwitches {
  int textured, refraction, spec_table, base_floor;
  float falloff_scale, diffuse_gain;
};

// The shadow ray toward light sample `li` (a float4 each: x y z, 0) from the
// offset point (sox, soy, soz) of the hit point (px, py, pz), and the
// distance to the light.
__device__ __forceinline__ void light_ray(const float4* light, int li, float px, float py,
                                          float pz, float sox, float soy, float soz, Ray& sr,
                                          float& dist, bool& near_ok) {
  const float4 lp = light[li];
  const float tlx = lp.x - px;
  const float tly = lp.y - py;
  const float tlz = lp.z - pz;
  dist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
  near_ok = dist > 0.001f;
  const float inv_d = 1.0f / (near_ok ? dist : 1.0f);
  sr.ox = sox; sr.oy = soy; sr.oz = soz;
  sr.dx = tlx * inv_d; sr.dy = tly * inv_d; sr.dz = tlz * inv_d;
}

__global__ void __launch_bounds__(kWhittedThreads)
whitted_bounce_persistent(const float* __restrict__ blob_g, int P, int S, int Q, int T,
                          const float* __restrict__ mat_g, int n_mats,
                          const float* __restrict__ light_g, int n_lights,
                          const float* __restrict__ ox_in, const float* __restrict__ oy_in,
                          const float* __restrict__ oz_in, const float* __restrict__ dx_in,
                          const float* __restrict__ dy_in, const float* __restrict__ dz_in,
                          float* __restrict__ out, int* __restrict__ prim_out, int n,
                          float t_min, float t_max, WhittedSwitches sw,
                          int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  const SceneLayout L = scene_layout(P, S, Q, T);
  const RecLayout R = rec_layout(P, S, Q, T);
  float* smem = reinterpret_cast<float*>(smem4);
  stage_records(smem, blob_g, L, R);
  float* mat = smem + mat_offset(R);
  float4* light = reinterpret_cast<float4*>(smem + light_offset(R, kWMatFields * n_mats));
  for (int k = threadIdx.x; k < kWMatFields * n_mats; k += blockDim.x) mat[k] = mat_g[k];
  for (int k = threadIdx.x; k < n_lights; k += blockDim.x)
    light[k] = make_float4(light_g[k], light_g[n_lights + k], light_g[2 * n_lights + k], 0.0f);
  __syncthreads();
  const float4* rec = smem4;
  const size_t N = (size_t)n;

  const int lane = threadIdx.x & 31;
  const int span = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;; i = next_batch(counter, span, n)) {
    if (i - lane >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    Ray r;
    r.ox = ox_in[i]; r.oy = oy_in[i]; r.oz = oz_in[i];
    r.dx = dx_in[i]; r.dy = dy_in[i]; r.dz = dz_in[i];

    // ---- closest hit with carried attributes ------------------------------
    const Hit h = closest_hit16(rec, R, r, t_min, t_max);
    const bool hit = h.prim >= 0;
    const float px = r.ox + r.dx * h.t;
    const float py = r.oy + r.dy * h.t;
    const float pz = r.oz + r.dz * h.t;
    const float nx = h.nx, ny = h.ny, nz = h.nz;
    float* o = out + i;

    // ---- the winner's material (zeros, ior 1, tex -1 on a miss); the
    // fields the light loop does not read go out first ---------------------
    const int m = h.prim;
    const float diffuse = hit ? mat[3 * n_mats + m] : 0.0f;
    const float specular = hit ? mat[4 * n_mats + m] : 0.0f;
    const float reflective = hit ? mat[5 * n_mats + m] : 0.0f;
    o[0 * N] = hit ? 1.0f : 0.0f;
    o[11 * N] = h.u;
    o[12 * N] = h.v;
    o[13 * N] = (sw.textured && hit && mat[8 * n_mats + m] > 0.5f) ? mat[9 * n_mats + m] : -1.0f;
    o[14 * N] = hit ? mat[0 * n_mats + m] : 0.0f;
    o[15 * N] = hit ? mat[1 * n_mats + m] : 0.0f;
    o[16 * N] = hit ? mat[2 * n_mats + m] : 0.0f;
    prim_out[i] = m;

    // ---- ambient + area-light loop (cuda_texture_renderer.py:221-334) -----
    float a_acc = 0.4f;  // hard-coded GPU ambient
    float w_acc = 0.0f;
    const float sox = px + nx * kWEps;
    const float soy = py + ny * kWEps;
    const float soz = pz + nz * kWEps;
    const float inv_l = 1.0f / (float)(n_lights > 1 ? n_lights : 1);
    // the specular class of the material (spec_table variant)
    const bool chrome = reflective > 0.9f && specular > 0.9f;
    const bool metal = reflective > 0.7f;
    const bool glossy = specular > 0.5f;
    const float shininess = chrome ? 256.0f : (metal ? 128.0f : (glossy ? 64.0f : 32.0f));
    const float multiplier = chrome ? 1.5f : (metal ? 1.2f : 1.0f);

    for (int li = 0; hit && li < n_lights; ++li) {  // a miss cares about no light
      Ray sr;
      float dist;
      bool near_ok;
      light_ray(light, li, px, py, pz, sox, soy, soz, sr, dist, near_ok);
      const float dot_nl = nx * sr.dx + ny * sr.dy + nz * sr.dz;
      const float diff = fmaxf(dot_nl, 0.0f);
      const float rx = 2.0f * dot_nl * nx - sr.dx;
      const float ry = 2.0f * dot_nl * ny - sr.dy;
      const float rz = 2.0f * dot_nl * nz - sr.dz;
      const float dot_rv = fmaxf(-(rx * r.dx + ry * r.dy + rz * r.dz), 0.0f);
      const bool spec_on = sw.spec_table ? (specular > 0.01f && diff > 0.0f)
                                         : (specular > 0.01f);
      // both terms are exactly zero whatever the occlusion: skip the sweep
      const bool care = near_ok && ((diff > 0.0f && diffuse > 0.0f) ||
                                    (spec_on && dot_rv > 0.0f));
      if (!care || any_hit16(rec, R, sr, t_min, dist - 0.001f)) continue;

      const float atten = sw.falloff_scale / (1.0f + 0.001f * dist + 0.0001f * dist * dist);
      a_acc = a_acc + diff * atten * inv_l * diffuse * sw.diffuse_gain;
      if (sw.spec_table) {
        if (spec_on) {
          const float spec_int = powf(dot_rv, shininess) * atten * multiplier * inv_l * specular;
          if (metal) {
            a_acc = a_acc + spec_int;  // tinted by base
          } else {
            w_acc = w_acc + spec_int;  // white highlight
          }
        }
      } else if (spec_on) {
        w_acc = w_acc + powf(dot_rv, 32.0f) * specular * atten * inv_l;
      }
    }

    // ---- energy factor + continuation (cuda_texture_renderer.py:336-423) --
    const float refractive = hit ? mat[6 * n_mats + m] : 0.0f;
    const float ior = hit ? mat[7 * n_mats + m] : 1.0f;
    const float energy = sw.base_floor ? fmaxf(0.1f, 1.0f - reflective - refractive)
                                       : 1.0f - reflective;
    a_acc = a_acc * energy;
    w_acc = w_acc * energy;

    const float dn = r.dx * nx + r.dy * ny + r.dz * nz;
    float ndx = r.dx - 2.0f * dn * nx;
    float ndy = r.dy - 2.0f * dn * ny;
    float ndz = r.dz - 2.0f * dn * nz;
    float off = kWEps;
    float mult = reflective;
    bool want;
    if (sw.refraction) {
      want = reflective > 0.01f || refractive > 0.01f;
      const bool use_refr = refractive > reflective && refractive > 0.1f;
      const bool inside = dn > 0.0f;
      const float onx = inside ? -nx : nx;
      const float ony = inside ? -ny : ny;
      const float onz = inside ? -nz : nz;
      const float eta = inside ? ior : 1.0f / ior;
      const float ci = -(r.dx * onx + r.dy * ony + r.dz * onz);
      const float sin2 = eta * eta * (1.0f - ci * ci);
      const bool refr_ok = sin2 <= 1.0f;
      const float cth = sqrtf(fmaxf(1.0f - sin2, 0.0f));
      const float fac = eta * ci - cth;
      if (use_refr && refr_ok) {
        ndx = eta * r.dx + fac * onx;
        ndy = eta * r.dy + fac * ony;
        ndz = eta * r.dz + fac * onz;
        // refraction offsets along +n when exiting, -n when entering (quirk)
        off = inside ? kWEps : -kWEps;
        mult = refractive * 0.95f;
      }
    } else {
      want = reflective > 0.01f;
    }

    o[1 * N] = a_acc;
    o[2 * N] = w_acc;
    o[3 * N] = (hit && want) ? 1.0f : 0.0f;
    o[4 * N] = mult;
    o[5 * N] = px + nx * off;
    o[6 * N] = py + ny * off;
    o[7 * N] = pz + nz * off;
    o[8 * N] = ndx;
    o[9 * N] = ndy;
    o[10 * N] = ndz;
  }
  if (span < n) finish_lanes(counter);
}

// The records, materials and lights in shared memory, in bytes.
inline size_t whitted_smem_bytes(int P, int S, int Q, int T, int n_mats, int n_lights) {
  return sizeof(float) *
         (size_t)table_floats(rec_layout(P, S, Q, T), kWMatFields * n_mats, n_lights);
}

}  // namespace ptrt

// Resident blocks per SM with `smem` bytes of dynamic shared memory, into
// *blocks; first lifts the kernel's dynamic shared memory limit to `smem`
// where it is lower.
extern "C" int ptrt_whitted_bounce_occupancy(int smem, int* blocks) {
  cudaError_t err = ptrt::allow_smem(ptrt::whitted_bounce_persistent, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ptrt::whitted_bounce_persistent,
                                                        ptrt::kWhittedThreads, smem);
  return (int)err;
}

// `grid` persistent blocks with `smem` bytes of dynamic shared memory, which
// ptrt_whitted_bounce_occupancy has allowed; `counter` is two int32 of
// scratch, zero at the launch and left zero by the kernel.  Launches on
// `stream`; allocates nothing and does not synchronise.  Returns the
// launch's cudaError_t (0 when the launch was accepted).
extern "C" int ptrt_whitted_bounce(const float* blob, int P, int S, int Q, int T,
                                   const float* mat, int n_mats, const float* lights,
                                   int n_lights, const float* ox, const float* oy,
                                   const float* oz, const float* dx, const float* dy,
                                   const float* dz, float* out, int* prim, int n, float t_min,
                                   float t_max, int textured, int refraction,
                                   float falloff_scale, float diffuse_gain, int spec_table,
                                   int base_floor, int* counter, int smem, int grid,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((size_t)smem < ptrt::whitted_smem_bytes(P, S, Q, T, n_mats, n_lights))
    return (int)cudaErrorInvalidValue;
  ptrt::WhittedSwitches sw;
  sw.textured = textured;
  sw.refraction = refraction;
  sw.spec_table = spec_table;
  sw.base_floor = base_floor;
  sw.falloff_scale = falloff_scale;
  sw.diffuse_gain = diffuse_gain;
  ptrt::whitted_bounce_persistent<<<grid, ptrt::kWhittedThreads, smem, (cudaStream_t)stream>>>(
      blob, P, S, Q, T, mat, n_mats, lights, n_lights, ox, oy, oz, dx, dy, dz, out, prim, n,
      t_min, t_max, sw, counter);
  return (int)cudaGetLastError();
}
