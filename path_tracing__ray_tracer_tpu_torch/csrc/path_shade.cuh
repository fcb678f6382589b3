// The path tracer's shading after the closest hit, shared by the bounce
// kernels path_bounce.cu (K1), path_bounce_bvh.cu (K5) and path_step.cu (K7,
// which keeps its own record): the counter RNG,
// the next-event-estimation query (uniform light pick, shadow ray, its bound
// and unoccluded weight), Russian roulette, the 60/25/15 glass event with
// the TIR fallback, the mirror / cosine-hemisphere scatter, and the write of
// the 19-field shading-weight record.  Port of the JAX package's
// bounce_pallas.py::_shade_scatter; built with --fmad=false like the plain
// torch ops it is held against.
//
// Output record, row-major (19, N) float32:
//   0 hit  1 killed  2 w_sky  3 w_nee  4 rr_scale  5 s_thr  6 t_thr
//   7-9 new origin  10-12 new direction  13 u  14 v  15 tex_id (-1 untextured)
//   16-18 material colour
// Miss lanes carry the kernels' convention: zero material, ior 1, tex -1.
#pragma once

#include <cstddef>
#include <cstdint>

#include "sweep.cuh"

namespace ptrt {

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

// the counter hash of the JAX package's ops/rng.py in native uint32
__device__ __forceinline__ float uniform01(uint32_t key, uint32_t depth, uint32_t use) {
  uint32_t h = fmix32((key ^ (depth * kGammaDepth)) + kInc);
  h = fmix32((h + use * kGammaUse) + kInc);
  return (float)(h >> 8) * (1.0f / 16777216.0f);  // top 24 bits, exact
}

// the winner's material record (fields read by the bounce)
struct Material {
  float r, g, b, diffuse, reflective, refractive, ior, has_tex, tex_id;
};

__device__ __forceinline__ Material miss_material() {
  return Material{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, -1.0f};
}

// row `m` of a field-major material table with `rows` rows
__device__ __forceinline__ Material material_row(const float* mat, int rows, int m) {
  return Material{mat[0 * rows + m], mat[1 * rows + m], mat[2 * rows + m],
                  mat[3 * rows + m], mat[5 * rows + m], mat[6 * rows + m],
                  mat[7 * rows + m], mat[8 * rows + m], mat[9 * rows + m]};
}

// The closest hit a bounce shades: hit flag, point, shading normal, UV.
struct Surface {
  bool hit;
  float px, py, pz, nx, ny, nz, u, v;
};

// The NEE shadow query: the ray toward the picked light sample, its bound,
// whether its answer matters (`care`), and the weight if unoccluded.
struct ShadowQuery {
  Ray ray;
  float bound;
  bool care;
  float w;
};

__device__ __forceinline__ ShadowQuery nee_query(const float* light, int n_lights, uint32_t key,
                                                 uint32_t depth, const Surface& s,
                                                 const Material& m, float t_max,
                                                 int shadow_light) {
  ShadowQuery q{Ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, -1.0f, false, 0.0f};
  if (n_lights <= 0) return q;
  const float r_light = uniform01(key, depth, kULight);
  const int li = min((int)(r_light * (float)n_lights), n_lights - 1);
  const float tlx = light[li] - s.px;
  const float tly = light[n_lights + li] - s.py;
  const float tlz = light[2 * n_lights + li] - s.pz;
  const float dist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
  const float inv = 1.0f / (dist > 0.001f ? dist : 1.0f);
  q.ray.dx = tlx * inv; q.ray.dy = tly * inv; q.ray.dz = tlz * inv;
  q.ray.ox = s.px + s.nx * kEps; q.ray.oy = s.py + s.ny * kEps; q.ray.oz = s.pz + s.nz * kEps;
  const float cos_t = fmaxf(q.ray.dx * s.nx + q.ray.dy * s.ny + q.ray.dz * s.nz, 0.0f);
  // lanes whose NEE weight is zero whatever the occlusion need no answer
  q.care = s.hit && cos_t > 0.0f && m.diffuse > 0.0f;
  // shadow bound: the reference quirk scans to t_max (occluders beyond the
  // light still shadow); shadow_light bounds it at the sampled light point
  q.bound = shadow_light ? dist - 1e-3f : t_max;
  const bool glass_cls = m.refractive > 0.5f;
  const bool mirror_cls = m.reflective > 0.7f;
  const float intensity = glass_cls ? 4.0f : (mirror_cls ? 2.5f : 2.0f);
  const float mult = glass_cls ? 0.6f : (mirror_cls ? 0.8f : 1.0f);
  q.w = m.diffuse * cos_t * intensity * mult * (float)n_lights;
  return q;
}

// What Russian roulette and the scatter event decide for one lane.
struct Scatter {
  bool killed;
  float rr_scale, s_thr, t_thr;
  float nox, noy, noz, ndx, ndy, ndz;  // the next ray
};

// Russian roulette and the scatter event of one lane.
__device__ __forceinline__ Scatter scatter(uint32_t key, uint32_t depth, const Ray& r, float thx,
                                           float thy, float thz, const Surface& s,
                                           const Material& m) {
  const float nx = s.nx, ny = s.ny, nz = s.nz;
  const float px = s.px, py = s.py, pz = s.pz;

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
  const float eta = entering ? 1.0f / m.ior : m.ior;
  const float onx = entering ? nx : -nx;
  const float ony = entering ? ny : -ny;
  const float onz = entering ? nz : -nz;
  const float ci = -(r.dx * onx + r.dy * ony + r.dz * onz);
  const float sin2 = eta * eta * (1.0f - ci * ci);
  const bool refr_ok = sin2 <= 1.0f;
  const float cth = sqrtf(fmaxf(1.0f - sin2, 0.0f));
  const float fac = eta * ci - cth;

  const bool glass = m.refractive > 0.1f;
  const bool mirror = !glass && m.reflective > 0.5f;
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
  const float s_thr = ev_refr ? (refr_ok ? m.refractive * (float)(1.0 / 0.6) : 0.9f) : 0.0f;
  float t_thr = ev_refl ? (float)(0.9 / 0.25)
                        : (ev_diff ? m.diffuse * (float)(3.0 / (1.0 - 0.6 - 0.25))
                                   : (mirror ? m.reflective : m.diffuse));
  if (ev_refr) t_thr = 0.0f;
  return Scatter{killed, rr_scale, s_thr, t_thr, nox, noy, noz, ndx, ndy, ndz};
}

// The base colour's texture id on the record: -1 when untextured.
__device__ __forceinline__ float record_tex(const Material& m) {
  return m.has_tex > 0.5f ? m.tex_id : -1.0f;
}

// The bytes of a K1 or K7 block's tables in shared memory: the records,
// the material table and the light samples (sweep.cuh table_floats).
inline size_t bounce_smem_bytes(int P, int S, int Q, int T, int n_mats, int n_lights) {
  return sizeof(float) *
         (size_t)table_floats(rec_layout(P, S, Q, T), kMatFields * n_mats, n_lights);
}

// Russian roulette, the scatter event and the record of lane `i` of `n`.
__device__ __forceinline__ void scatter_write(float* __restrict__ out, int n, int i, uint32_t key,
                                              uint32_t depth, const Ray& r, float thx,
                                              float thy, float thz, const Surface& s,
                                              const Material& m, float w_nee) {
  const Scatter c = scatter(key, depth, r, thx, thy, thz, s, m);
  float* o = out + i;
  const size_t N = (size_t)n;
  o[0 * N] = s.hit ? 1.0f : 0.0f;
  o[1 * N] = c.killed ? 1.0f : 0.0f;
  o[2 * N] = s.hit ? 0.0f : kSky;
  o[3 * N] = w_nee;
  o[4 * N] = c.rr_scale;
  o[5 * N] = c.s_thr;
  o[6 * N] = c.t_thr;
  o[7 * N] = c.nox;
  o[8 * N] = c.noy;
  o[9 * N] = c.noz;
  o[10 * N] = c.ndx;
  o[11 * N] = c.ndy;
  o[12 * N] = c.ndz;
  o[13 * N] = s.u;
  o[14 * N] = s.v;
  o[15 * N] = record_tex(m);
  o[16 * N] = m.r;
  o[17 * N] = m.g;
  o[18 * N] = m.b;
}

}  // namespace ptrt
