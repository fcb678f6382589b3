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
// Output record, row-major (19, N) float32, the field order of
// path_bounce_pallas' outputs:
//   0 hit  1 killed  2 w_sky  3 w_nee  4 rr_scale  5 s_thr  6 t_thr
//   7-9 new origin  10-12 new direction  13 u  14 v  15 tex_id (-1 untextured)
//   16-18 material colour
// plus `prim` (N,) int32, the winning global primitive id (-1 on miss).
// Miss lanes carry the kernel's convention: zero material, ior 1, tex -1.
//
// RNG: the counter hash of the JAX package's ops/rng.py in native uint32.
#include <cuda_runtime.h>

#include <cstdint>

#include "sweep.cuh"

namespace ptrt {

constexpr int kThreads = 256;
constexpr int kMatFields = 10;  // r g b diffuse specular reflective refractive ior has_tex tex_id
constexpr float kEps = 1e-3f;
constexpr float kSky = 0.1f;
constexpr uint32_t kGammaDepth = 0x9E3779B9u;
constexpr uint32_t kGammaUse = 0x85EBCA6Bu;
constexpr uint32_t kInc = 0x9E3779B9u;

// RNG use slots (JAX models/path_tracer.py)
constexpr uint32_t kULight = 0, kURr = 1, kUEvent = 2, kUHemi1 = 3, kUHemi2 = 4;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ float uniform01(uint32_t key, uint32_t depth, uint32_t use) {
  uint32_t h = fmix32((key ^ (depth * kGammaDepth)) + kInc);
  h = fmix32((h + use * kGammaUse) + kInc);
  return (float)(h >> 8) * (1.0f / 16777216.0f);  // top 24 bits, exact
}

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
  const float thx = tx_in[i], thy = ty_in[i], thz = tz_in[i];

  // ---- closest hit with carried attributes --------------------------------
  const Hit h = closest_hit(blob, L, r, t_min, t_max);
  const bool hit = h.prim >= 0;
  const float px = r.ox + r.dx * h.t;
  const float py = r.oy + r.dy * h.t;
  const float pz = r.oz + r.dz * h.t;
  const float nx = h.nx, ny = h.ny, nz = h.nz;

  // ---- the winner's material (zeros, ior 1, tex -1 on a miss) -------------
  float mr = 0.0f, mg = 0.0f, mb = 0.0f, diffuse = 0.0f, reflective = 0.0f;
  float refractive = 0.0f, ior = 1.0f, has_tex = 0.0f, tex_id = -1.0f;
  if (hit) {
    const int m = h.prim;
    mr = mat[0 * n_mats + m];
    mg = mat[1 * n_mats + m];
    mb = mat[2 * n_mats + m];
    diffuse = mat[3 * n_mats + m];
    reflective = mat[5 * n_mats + m];
    refractive = mat[6 * n_mats + m];
    ior = mat[7 * n_mats + m];
    has_tex = mat[8 * n_mats + m];
    tex_id = mat[9 * n_mats + m];
  }

  // ---- NEE: uniform light pick + shadow query -----------------------------
  float w_nee = 0.0f;
  if (n_lights > 0) {
    const float r_light = uniform01(key, depth, kULight);
    const int li = min((int)(r_light * (float)n_lights), n_lights - 1);
    const float tlx = light[li] - px;
    const float tly = light[n_lights + li] - py;
    const float tlz = light[2 * n_lights + li] - pz;
    const float dist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
    const float inv = 1.0f / (dist > 0.001f ? dist : 1.0f);
    Ray sr;
    sr.dx = tlx * inv; sr.dy = tly * inv; sr.dz = tlz * inv;
    sr.ox = px + nx * kEps; sr.oy = py + ny * kEps; sr.oz = pz + nz * kEps;
    const float cos_t = fmaxf(sr.dx * nx + sr.dy * ny + sr.dz * nz, 0.0f);
    // lanes whose NEE weight is zero whatever the occlusion skip the sweep
    const bool care = hit && cos_t > 0.0f && diffuse > 0.0f;
    // shadow bound: the reference quirk scans to t_max (occluders beyond the
    // light still shadow); shadow_light bounds it at the sampled light point
    const float bound = shadow_light ? dist - 1e-3f : t_max;
    if (care && !any_hit(blob, L, sr, t_min, bound)) {
      const bool glass_cls = refractive > 0.5f;
      const bool mirror_cls = reflective > 0.7f;
      const float intensity = glass_cls ? 4.0f : (mirror_cls ? 2.5f : 2.0f);
      const float mult = glass_cls ? 0.6f : (mirror_cls ? 0.8f : 1.0f);
      w_nee = diffuse * cos_t * intensity * mult * (float)n_lights;
    }
  }

  // ---- Russian roulette -----------------------------------------------------
  const float luma = 0.299f * thx + 0.587f * thy + 0.114f * thz;
  const float survival = fmaxf(0.1f, luma);
  const bool rr_on = depth >= 3u;
  const bool killed = rr_on && uniform01(key, depth, kURr) > survival;
  const float rr_scale = (rr_on && !killed) ? 1.0f / survival : 1.0f;

  // ---- scatter event ---------------------------------------------------------
  const float choice = uniform01(key, depth, kUEvent);
  const float r1 = uniform01(key, depth, kUHemi1);
  const float r2 = uniform01(key, depth, kUHemi2);

  // mirror reflection of d about n
  const float dn = r.dx * nx + r.dy * ny + r.dz * nz;
  const float rfx = r.dx - 2.0f * dn * nx;
  const float rfy = r.dy - 2.0f * dn * ny;
  const float rfz = r.dz - 2.0f * dn * nz;

  // cosine hemisphere about n (reference tangent frame)
  const float ct = sqrtf(r1);
  const float st = sqrtf(fmaxf(1.0f - r1, 0.0f));
  const float phi = (float)6.283185307179586 * r2;
  const float hx_l = st * cosf(phi);
  const float hy_l = st * sinf(phi);
  const bool steep = fabsf(nz) > 0.9f;
  const float ntx = steep ? 1.0f : 0.0f;
  const float ntz = steep ? 0.0f : 1.0f;
  float ux = -ntz * ny;  // u = nt × n (nt.y == 0)
  float uy = ntz * nx - ntx * nz;
  float uz = ntx * ny;
  const float ul = sqrtf(ux * ux + uy * uy + uz * uz);
  const float inv_ul = 1.0f / (ul > 0.0f ? ul : 1.0f);
  ux = ux * inv_ul; uy = uy * inv_ul; uz = uz * inv_ul;
  const float vx = ny * uz - nz * uy;
  const float vy = nz * ux - nx * uz;
  const float vz = nx * uy - ny * ux;
  const float hmx = hx_l * ux + hy_l * vx + ct * nx;
  const float hmy = hx_l * uy + hy_l * vy + ct * ny;
  const float hmz = hx_l * uz + hy_l * vz + ct * nz;

  // glass refraction (reference entering / eta rules)
  const float cos_i = fmaxf(0.0f, -(r.dx * nx + r.dy * ny + r.dz * nz));
  const bool entering = cos_i > 0.0f;
  const float eta = entering ? 1.0f / ior : ior;
  const float onx = entering ? nx : -nx;
  const float ony = entering ? ny : -ny;
  const float onz = entering ? nz : -nz;
  const float ci = -(r.dx * onx + r.dy * ony + r.dz * onz);
  const float sin2 = eta * eta * (1.0f - ci * ci);
  const bool refr_ok = sin2 <= 1.0f;
  const float cth = sqrtf(fmaxf(1.0f - sin2, 0.0f));
  const float fac = eta * ci - cth;

  const bool glass = refractive > 0.1f;
  const bool mirror = !glass && reflective > 0.5f;
  const bool ev_refr = glass && choice < 0.6f;
  const bool ev_refl = glass && !ev_refr && choice < (float)(0.6 + 0.25);
  const bool ev_diff = glass && !ev_refr && !ev_refl;
  const bool use_hemi = ev_diff || (!glass && !mirror);
  const bool refracts = ev_refr && refr_ok;

  const float ndx = refracts ? eta * r.dx + fac * onx : (use_hemi ? hmx : rfx);
  const float ndy = refracts ? eta * r.dy + fac * ony : (use_hemi ? hmy : rfy);
  const float ndz = refracts ? eta * r.dz + fac * onz : (use_hemi ? hmz : rfz);

  // origin: refraction offsets −n when entering, +n otherwise (quirk)
  const bool off_in = refracts && entering;
  const float nox = off_in ? px - nx * kEps : px + nx * kEps;
  const float noy = off_in ? py - ny * kEps : py + ny * kEps;
  const float noz = off_in ? pz - nz * kEps : pz + nz * kEps;

  // throughput multiplier: thr *= (s + base·t)
  const float s_thr = ev_refr ? (refr_ok ? refractive * (float)(1.0 / 0.6) : 0.9f) : 0.0f;
  float t_thr = ev_refl ? (float)(0.9 / 0.25)
                        : (ev_diff ? diffuse * (float)(3.0 / (1.0 - 0.6 - 0.25))
                                   : (mirror ? reflective : diffuse));
  if (ev_refr) t_thr = 0.0f;

  float* o = out + i;
  const size_t N = (size_t)n;
  o[0 * N] = hit ? 1.0f : 0.0f;
  o[1 * N] = killed ? 1.0f : 0.0f;
  o[2 * N] = hit ? 0.0f : kSky;
  o[3 * N] = w_nee;
  o[4 * N] = rr_scale;
  o[5 * N] = s_thr;
  o[6 * N] = t_thr;
  o[7 * N] = nox;
  o[8 * N] = noy;
  o[9 * N] = noz;
  o[10 * N] = ndx;
  o[11 * N] = ndy;
  o[12 * N] = ndz;
  o[13 * N] = h.u;
  o[14 * N] = h.v;
  o[15 * N] = has_tex > 0.5f ? tex_id : -1.0f;
  o[16 * N] = mr;
  o[17 * N] = mg;
  o[18 * N] = mb;
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
