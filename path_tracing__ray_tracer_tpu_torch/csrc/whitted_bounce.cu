// One whole Whitted bounce, one ray per thread.
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
// operations per primitive test.  The design:
//   * the scene (primitive blob, material table, light samples; 2.4 KB for
//     the Cornell box) is copied into shared memory at block start, so every
//     primitive read is a broadcast to the warp;
//   * a shadow sweep stops at its first occluder (sweep.cuh any_hit), and
//     is skipped for a light whose Lambert and Phong terms are both exactly
//     zero whatever the occlusion (a miss, the light behind the surface, a
//     black material): adding 0 leaves the sums bit for bit as they were.
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

#include "sweep.cuh"

namespace ptrt {

constexpr int kWhittedThreads = 256;
constexpr int kWMatFields = 10;  // r g b diffuse specular reflective refractive ior has_tex tex_id
constexpr float kWEps = 1e-3f;

struct WhittedSwitches {
  int textured, refraction, spec_table, base_floor;
  float falloff_scale, diffuse_gain;
};

__global__ void __launch_bounds__(kWhittedThreads)
whitted_bounce_kernel(const float* __restrict__ blob_g, int P, int S, int Q, int T,
                      const float* __restrict__ mat_g, int n_mats,
                      const float* __restrict__ light_g, int n_lights,
                      const float* __restrict__ ox_in, const float* __restrict__ oy_in,
                      const float* __restrict__ oz_in, const float* __restrict__ dx_in,
                      const float* __restrict__ dy_in, const float* __restrict__ dz_in,
                      float* __restrict__ out, int* __restrict__ prim_out, int n, float t_min,
                      float t_max, WhittedSwitches sw) {
  extern __shared__ float smem[];
  const SceneLayout L = scene_layout(P, S, Q, T);
  const int blob_size = L.tb + 18 * T;
  const int mat_size = kWMatFields * n_mats;
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

  Ray r;
  r.ox = ox_in[i]; r.oy = oy_in[i]; r.oz = oz_in[i];
  r.dx = dx_in[i]; r.dy = dy_in[i]; r.dz = dz_in[i];

  // ---- closest hit with carried attributes --------------------------------
  const Hit h = closest_hit(blob, L, r, t_min, t_max);
  const bool hit = h.prim >= 0;
  const float px = r.ox + r.dx * h.t;
  const float py = r.oy + r.dy * h.t;
  const float pz = r.oz + r.dz * h.t;
  const float nx = h.nx, ny = h.ny, nz = h.nz;

  // ---- the winner's material (zeros, ior 1, tex -1 on a miss) -------------
  float mr = 0.0f, mg = 0.0f, mb = 0.0f, diffuse = 0.0f, specular = 0.0f;
  float reflective = 0.0f, refractive = 0.0f, ior = 1.0f, has_tex = 0.0f, tex_id = -1.0f;
  if (hit) {
    const int m = h.prim;
    mr = mat[0 * n_mats + m];
    mg = mat[1 * n_mats + m];
    mb = mat[2 * n_mats + m];
    diffuse = mat[3 * n_mats + m];
    specular = mat[4 * n_mats + m];
    reflective = mat[5 * n_mats + m];
    refractive = mat[6 * n_mats + m];
    ior = mat[7 * n_mats + m];
    has_tex = mat[8 * n_mats + m];
    tex_id = mat[9 * n_mats + m];
  }

  // ---- ambient + area-light loop (cuda_texture_renderer.py:221-334) -------
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

  for (int li = 0; li < n_lights; ++li) {
    const float tlx = light[li] - px;
    const float tly = light[n_lights + li] - py;
    const float tlz = light[2 * n_lights + li] - pz;
    const float dist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
    const bool near_ok = dist > 0.001f;
    const float inv_d = 1.0f / (near_ok ? dist : 1.0f);
    Ray sr;
    sr.ox = sox; sr.oy = soy; sr.oz = soz;
    sr.dx = tlx * inv_d; sr.dy = tly * inv_d; sr.dz = tlz * inv_d;

    const float dot_nl = nx * sr.dx + ny * sr.dy + nz * sr.dz;
    const float diff = fmaxf(dot_nl, 0.0f);
    const float rx = 2.0f * dot_nl * nx - sr.dx;
    const float ry = 2.0f * dot_nl * ny - sr.dy;
    const float rz = 2.0f * dot_nl * nz - sr.dz;
    const float dot_rv = fmaxf(-(rx * r.dx + ry * r.dy + rz * r.dz), 0.0f);
    const bool spec_on = sw.spec_table ? (specular > 0.01f && diff > 0.0f)
                                       : (specular > 0.01f);
    // both terms are exactly zero whatever the occlusion: skip the sweep
    const bool care = hit && near_ok && ((diff > 0.0f && diffuse > 0.0f) ||
                                         (spec_on && dot_rv > 0.0f));
    if (!care || any_hit(blob, L, sr, t_min, dist - 0.001f)) continue;

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

  // ---- energy factor + continuation (cuda_texture_renderer.py:336-423) ----
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

  float* o = out + i;
  const size_t N = (size_t)n;
  o[0 * N] = hit ? 1.0f : 0.0f;
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
  o[11 * N] = h.u;
  o[12 * N] = h.v;
  o[13 * N] = (sw.textured && has_tex > 0.5f) ? tex_id : -1.0f;
  o[14 * N] = mr;
  o[15 * N] = mg;
  o[16 * N] = mb;
  prim_out[i] = h.prim;
}

}  // namespace ptrt

// Launches on `stream`; allocates nothing and does not synchronise.  Returns
// the launch's cudaError_t (0 when the launch was accepted).
extern "C" int ptrt_whitted_bounce(const float* blob, int P, int S, int Q, int T,
                                   const float* mat, int n_mats, const float* lights,
                                   int n_lights, const float* ox, const float* oy,
                                   const float* oz, const float* dx, const float* dy,
                                   const float* dz, float* out, int* prim, int n, float t_min,
                                   float t_max, int textured, int refraction,
                                   float falloff_scale, float diffuse_gain, int spec_table,
                                   int base_floor, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blob_size = 14 * P + 4 * S + 18 * Q + 18 * T;
  const size_t smem =
      sizeof(float) * (size_t)(blob_size + ptrt::kWMatFields * n_mats + 3 * n_lights);
  const int blocks = (n + ptrt::kWhittedThreads - 1) / ptrt::kWhittedThreads;
  ptrt::WhittedSwitches sw;
  sw.textured = textured;
  sw.refraction = refraction;
  sw.spec_table = spec_table;
  sw.base_floor = base_floor;
  sw.falloff_scale = falloff_scale;
  sw.diffuse_gain = diffuse_gain;
  ptrt::whitted_bounce_kernel<<<blocks, ptrt::kWhittedThreads, smem, (cudaStream_t)stream>>>(
      blob, P, S, Q, T, mat, n_mats, lights, n_lights, ox, oy, oz, dx, dy, dz, out, prim, n,
      t_min, t_max, sw);
  return (int)cudaGetLastError();
}
