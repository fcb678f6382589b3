// Brute-force primitive sweep over the packed scene blob, one ray per thread.
//
// Replaces the body of the JAX package's
// ops/pallas/intersect_pallas.py::_sweep_prims, which the TPU kernels
// _path_bounce_kernel (K1), _closest_kernel / _any_kernel (K3) and
// _whitted_bounce_kernel (K2) all share.  Semantics kept exactly:
//   * fixed order planes -> spheres -> quads -> triangles, global ids
//     P + S + Q + i, strict `<` against the running best (ties keep the
//     earlier primitive);
//   * `ok ? denom : 1` guards before each division;
//   * the sphere's extra `tt > 0` test, sphere UVs fixed at 0;
//   * quad and triangle normals flipped toward the ray.
//
// Blob layout (pack_scene_blob): per-field contiguous, field f of primitive i
// of a type with `count` rows at `base + f * count + i`.
//   planes    14 fields: anchor(3) normal(3) u_unit(3) v_unit(3) u_len v_len
//   spheres    4 fields: center(3) radius
//   quads     18 fields: origin(3) normal(3) du(3) dv(3) uv0(2) uva(2) uvb(2)
//   triangles 18 fields: v0(3) e1(3) e2(3) normal(3) uv0(2) uv1(2) uv2(2)
//
// Every thread of a warp reads the same primitive at the same time, so with
// the blob in shared memory each read is a broadcast.  Primitive counts are
// runtime ints.  Built with --fmad=false so each product and sum rounds on
// its own, as the plain torch ops do.
#pragma once

#include <cstdint>

namespace ptrt {

struct SceneLayout {
  int P, S, Q, T;      // primitive counts (padded, >= 1 each)
  int pb, sb, qb, tb;  // field bases in the blob
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Hit {
  float t;
  int prim;  // -1 on miss
  float nx, ny, nz, u, v;
};

__device__ __forceinline__ SceneLayout scene_layout(int P, int S, int Q, int T) {
  SceneLayout L;
  L.P = P; L.S = S; L.Q = Q; L.T = T;
  L.pb = 0;
  L.sb = L.pb + 14 * P;
  L.qb = L.sb + 4 * S;
  L.tb = L.qb + 18 * Q;
  return L;
}

// ---- per-primitive tests: return whether the primitive wins against `best`

__device__ __forceinline__ bool plane_test(const float* f, int n, int i, const Ray& r,
                                           float t_min, float best, float& tt,
                                           float& u_hit, float& v_hit) {
  const float ax = f[0 * n + i], ay = f[1 * n + i], az = f[2 * n + i];
  const float px = f[3 * n + i], py = f[4 * n + i], pz = f[5 * n + i];
  const float denom = r.dx * px + r.dy * py + r.dz * pz;
  const bool ok = fabsf(denom) > 1e-6f;
  tt = ((ax - r.ox) * px + (ay - r.oy) * py + (az - r.oz) * pz) / (ok ? denom : 1.0f);
  const float hx = r.ox + r.dx * tt - ax;
  const float hy = r.oy + r.dy * tt - ay;
  const float hz = r.oz + r.dz * tt - az;
  u_hit = hx * f[6 * n + i] + hy * f[7 * n + i] + hz * f[8 * n + i];
  v_hit = hx * f[9 * n + i] + hy * f[10 * n + i] + hz * f[11 * n + i];
  return ok && tt > t_min && tt < best && u_hit >= 0.0f && u_hit <= f[12 * n + i] &&
         v_hit >= 0.0f && v_hit <= f[13 * n + i];
}

__device__ __forceinline__ bool sphere_test(const float* f, int n, int i, const Ray& r,
                                            float t_min, float best, float& tt) {
  const float cx = f[0 * n + i], cy = f[1 * n + i], cz = f[2 * n + i];
  const float rad = f[3 * n + i];
  const float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float bq = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = bq * bq - a * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t1 = (-bq - sq) / a;
  const float t2 = (-bq + sq) / a;
  const bool t1ok = t1 > t_min && t1 < best;
  const bool t2ok = t2 > t_min && t2 < best;
  tt = t1ok ? t1 : t2;
  return disc > 0.0f && (t1ok || t2ok) && tt > 0.0f;
}

__device__ __forceinline__ bool quad_test(const float* f, int n, int i, const Ray& r,
                                          float t_min, float best, float& tt,
                                          float& denom, float& a, float& b) {
  const float oxq = f[0 * n + i], oyq = f[1 * n + i], ozq = f[2 * n + i];
  const float qnx = f[3 * n + i], qny = f[4 * n + i], qnz = f[5 * n + i];
  denom = r.dx * qnx + r.dy * qny + r.dz * qnz;
  const bool ok = fabsf(denom) > 1e-6f;
  tt = ((oxq - r.ox) * qnx + (oyq - r.oy) * qny + (ozq - r.oz) * qnz) / (ok ? denom : 1.0f);
  const float relx = r.ox + r.dx * tt - oxq;
  const float rely = r.oy + r.dy * tt - oyq;
  const float relz = r.oz + r.dz * tt - ozq;
  a = relx * f[6 * n + i] + rely * f[7 * n + i] + relz * f[8 * n + i];
  b = relx * f[9 * n + i] + rely * f[10 * n + i] + relz * f[11 * n + i];
  return ok && tt > t_min && tt < best && a >= 0.0f && a <= 1.0f && b >= 0.0f && b <= 1.0f;
}

// Möller–Trumbore of one triangle given by v0, e1 = v1 - v0 and e2 = v2 - v0
// (the tables and the BVH slot records store those): writes t and the
// barycentrics, returns whether it hits in (t_min, best).
__device__ __forceinline__ bool moller_trumbore(float v0x, float v0y, float v0z, float e1x,
                                                float e1y, float e1z, float e2x, float e2y,
                                                float e2z, const Ray& r, float t_min, float best,
                                                float& tt, float& bu, float& bv) {
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * hx + e1y * hy + e1z * hz;
  const bool ok = fabsf(det) > 1e-6f;
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
  bu = inv_det * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  bv = inv_det * (r.dx * qx + r.dy * qy + r.dz * qz);
  tt = inv_det * (e2x * qx + e2y * qy + e2z * qz);
  return ok && bu >= 0.0f && bu <= 1.0f && bv >= 0.0f && bu + bv <= 1.0f && tt > t_min &&
         tt < best;
}

__device__ __forceinline__ bool tri_test(const float* f, int n, int i, const Ray& r,
                                         float t_min, float best, float& tt, float& bu,
                                         float& bv) {
  return moller_trumbore(f[0 * n + i], f[1 * n + i], f[2 * n + i], f[3 * n + i], f[4 * n + i],
                         f[5 * n + i], f[6 * n + i], f[7 * n + i], f[8 * n + i], r, t_min, best,
                         tt, bu, bv);
}

// ---- closest hit with the winner's shading normal and UV ------------------

__device__ __forceinline__ Hit closest_hit(const float* blob, const SceneLayout& L,
                                           const Ray& r, float t_min, float bound) {
  Hit h;
  h.t = bound;
  h.prim = -1;
  h.nx = h.ny = h.nz = h.u = h.v = 0.0f;
  float tt, p, q, s;

  const float* f = blob + L.pb;
  for (int i = 0; i < L.P; ++i) {
    if (plane_test(f, L.P, i, r, t_min, h.t, tt, p, q)) {
      h.t = tt;
      h.prim = i;
      h.nx = f[3 * L.P + i];
      h.ny = f[4 * L.P + i];
      h.nz = f[5 * L.P + i];
      h.u = p / f[12 * L.P + i];
      h.v = q / f[13 * L.P + i];
    }
  }
  f = blob + L.sb;
  for (int i = 0; i < L.S; ++i) {
    if (sphere_test(f, L.S, i, r, t_min, h.t, tt)) {
      const float rad = f[3 * L.S + i];
      const float inv_r = 1.0f / (rad > 0.0f ? rad : 1.0f);
      h.t = tt;
      h.prim = L.P + i;
      h.nx = (r.ox + r.dx * tt - f[0 * L.S + i]) * inv_r;
      h.ny = (r.oy + r.dy * tt - f[1 * L.S + i]) * inv_r;
      h.nz = (r.oz + r.dz * tt - f[2 * L.S + i]) * inv_r;
      h.u = 0.0f;  // sphere UVs fixed at 0 (reference quirk 3)
      h.v = 0.0f;
    }
  }
  f = blob + L.qb;
  for (int i = 0; i < L.Q; ++i) {
    if (quad_test(f, L.Q, i, r, t_min, h.t, tt, s, p, q)) {
      const float sgn = s > 0.0f ? -1.0f : 1.0f;  // flip toward the ray
      h.t = tt;
      h.prim = L.P + L.S + i;
      h.nx = sgn * f[3 * L.Q + i];
      h.ny = sgn * f[4 * L.Q + i];
      h.nz = sgn * f[5 * L.Q + i];
      h.u = f[12 * L.Q + i] + p * f[14 * L.Q + i] + q * f[16 * L.Q + i];
      h.v = f[13 * L.Q + i] + p * f[15 * L.Q + i] + q * f[17 * L.Q + i];
    }
  }
  f = blob + L.tb;
  for (int i = 0; i < L.T; ++i) {
    if (tri_test(f, L.T, i, r, t_min, h.t, tt, p, q)) {
      const float tnx = f[9 * L.T + i], tny = f[10 * L.T + i], tnz = f[11 * L.T + i];
      const float sgn = r.dx * tnx + r.dy * tny + r.dz * tnz > 0.0f ? -1.0f : 1.0f;
      const float bw = 1.0f - p - q;
      h.t = tt;
      h.prim = L.P + L.S + L.Q + i;
      h.nx = sgn * tnx;
      h.ny = sgn * tny;
      h.nz = sgn * tnz;
      h.u = bw * f[12 * L.T + i] + p * f[14 * L.T + i] + q * f[16 * L.T + i];
      h.v = bw * f[13 * L.T + i] + p * f[15 * L.T + i] + q * f[17 * L.T + i];
    }
  }
  return h;
}

// ---- occlusion: is any primitive hit in (t_min, bound)? ---------------------
// The first primitive that passes against the initial bound decides, so the
// sweep stops there; the answer equals `closest_hit(...).prim >= 0`.

__device__ __forceinline__ bool any_hit(const float* blob, const SceneLayout& L, const Ray& r,
                                        float t_min, float bound) {
  float tt, p, q, s;
  const float* f = blob + L.pb;
  for (int i = 0; i < L.P; ++i)
    if (plane_test(f, L.P, i, r, t_min, bound, tt, p, q)) return true;
  f = blob + L.sb;
  for (int i = 0; i < L.S; ++i)
    if (sphere_test(f, L.S, i, r, t_min, bound, tt)) return true;
  f = blob + L.qb;
  for (int i = 0; i < L.Q; ++i)
    if (quad_test(f, L.Q, i, r, t_min, bound, tt, s, p, q)) return true;
  f = blob + L.tb;
  for (int i = 0; i < L.T; ++i)
    if (tri_test(f, L.T, i, r, t_min, bound, tt, p, q)) return true;
  return false;
}

// ---- the same sweeps over primitive-major 16-byte records (K1, K2) ---------
// The records (ops/cuda/bounce.py pack_scene_rec16) hold the blob's fields
// per primitive, in the blob's field order, padded with zeros to whole
// 16-byte records: plane 16 floats (its 14 fields), sphere 4, quad and
// triangle 20 (18 fields); each type's records contiguous, in the order
// planes, spheres, quads, triangles.  A test reads its record as float4
// loads: a plane 4, a sphere 1, a quad or triangle 3 (the Möller–Trumbore
// floats and the normal come first; the UVs, 2 more loads, only on a win).
// Each test is the field-major test above expression for expression, so a
// lane's answer is the same bits.

constexpr int kPlaneRec = 16, kSphereRec = 4, kQuadRec = 20, kTriRec = 20;

struct RecLayout {
  int P, S, Q, T;      // primitive counts, as SceneLayout's
  int pb, sb, qb, tb;  // record bases, in float4s
  int size4;           // float4s of all records
};

__host__ __device__ __forceinline__ RecLayout rec_layout(int P, int S, int Q, int T) {
  RecLayout R;
  R.P = P; R.S = S; R.Q = Q; R.T = T;
  R.pb = 0;
  R.sb = R.pb + kPlaneRec / 4 * P;
  R.qb = R.sb + kSphereRec / 4 * S;
  R.tb = R.qb + kQuadRec / 4 * Q;
  R.size4 = R.tb + kTriRec / 4 * T;
  return R;
}

// Copy the field-major blob's primitives into the records at `rec` (shared
// memory), every thread of the block taking part: thread k reads blob float
// k, so a warp's reads are consecutive, and stores it in its record; then
// the pads are zeroed.  The caller syncs the block before reading them.
__device__ __forceinline__ void stage_records(float* __restrict__ rec,
                                              const float* __restrict__ blob,
                                              const SceneLayout& L, const RecLayout& R) {
  const int size = L.tb + 18 * L.T;
  for (int k = threadIdx.x; k < size; k += blockDim.x) {
    int base = L.tb, count = L.T, width = kTriRec, first = R.tb;
    if (k < L.sb) {
      base = L.pb; count = L.P; width = kPlaneRec; first = R.pb;
    } else if (k < L.qb) {
      base = L.sb; count = L.S; width = kSphereRec; first = R.sb;
    } else if (k < L.tb) {
      base = L.qb; count = L.Q; width = kQuadRec; first = R.qb;
    }
    const int f = (k - base) / count, i = k - base - f * count;
    rec[4 * first + width * i + f] = blob[k];
  }
  // the last two floats of each plane, quad and triangle record
  for (int j = threadIdx.x; j < L.P + L.Q + L.T; j += blockDim.x) {
    float* r = j < L.P ? rec + 4 * R.pb + kPlaneRec * (j + 1)
               : j < L.P + L.Q ? rec + 4 * R.qb + kQuadRec * (j - L.P + 1)
                               : rec + 4 * R.tb + kTriRec * (j - L.P - L.Q + 1);
    r[-2] = 0.0f;
    r[-1] = 0.0f;
  }
}

// The floats of a K1, K2 or K7 block's tables in shared memory: the records,
// then the material table padded to whole float4s, then 4 floats a light
// sample (ops/cuda/bounce.py sweep_plan).
__host__ __device__ __forceinline__ int mat_offset(const RecLayout& R) { return 4 * R.size4; }
__host__ __device__ __forceinline__ int light_offset(const RecLayout& R, int mat_floats) {
  return mat_offset(R) + ((mat_floats + 3) & ~3);
}
__host__ __device__ __forceinline__ int table_floats(const RecLayout& R, int mat_floats,
                                                     int n_lights) {
  return light_offset(R, mat_floats) + 4 * n_lights;
}

// plane: anchor(3) normal(3) u_unit(3) v_unit(3) u_len v_len
__device__ __forceinline__ bool plane_test16(const float4* __restrict__ q, const Ray& r,
                                             float t_min, float best, float& tt, float& u_hit,
                                             float& v_hit, float4& a, float4& b, float4& d) {
  a = q[0];
  b = q[1];
  const float4 c = q[2];
  d = q[3];
  const float ax = a.x, ay = a.y, az = a.z;
  const float px = a.w, py = b.x, pz = b.y;
  const float denom = r.dx * px + r.dy * py + r.dz * pz;
  const bool ok = fabsf(denom) > 1e-6f;
  tt = ((ax - r.ox) * px + (ay - r.oy) * py + (az - r.oz) * pz) / (ok ? denom : 1.0f);
  const float hx = r.ox + r.dx * tt - ax;
  const float hy = r.oy + r.dy * tt - ay;
  const float hz = r.oz + r.dz * tt - az;
  u_hit = hx * b.z + hy * b.w + hz * c.x;
  v_hit = hx * c.y + hy * c.z + hz * c.w;
  return ok && tt > t_min && tt < best && u_hit >= 0.0f && u_hit <= d.x && v_hit >= 0.0f &&
         v_hit <= d.y;
}

// sphere: center(3) radius
__device__ __forceinline__ bool sphere_test16(const float4 c, const Ray& r, float t_min,
                                              float best, float& tt) {
  const float ocx = r.ox - c.x, ocy = r.oy - c.y, ocz = r.oz - c.z;
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float bq = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - c.w * c.w;
  const float disc = bq * bq - a * cc;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t1 = (-bq - sq) / a;
  const float t2 = (-bq + sq) / a;
  const bool t1ok = t1 > t_min && t1 < best;
  const bool t2ok = t2 > t_min && t2 < best;
  tt = t1ok ? t1 : t2;
  return disc > 0.0f && (t1ok || t2ok) && tt > 0.0f;
}

// quad: origin(3) normal(3) du(3) dv(3), then uv0(2) uva(2) uvb(2)
__device__ __forceinline__ bool quad_test16(const float4* __restrict__ q, const Ray& r,
                                            float t_min, float best, float& tt, float& denom,
                                            float& a, float& b, float4& r0, float4& r1) {
  r0 = q[0];
  r1 = q[1];
  const float4 r2 = q[2];
  const float qnx = r0.w, qny = r1.x, qnz = r1.y;
  denom = r.dx * qnx + r.dy * qny + r.dz * qnz;
  const bool ok = fabsf(denom) > 1e-6f;
  tt = ((r0.x - r.ox) * qnx + (r0.y - r.oy) * qny + (r0.z - r.oz) * qnz) / (ok ? denom : 1.0f);
  const float relx = r.ox + r.dx * tt - r0.x;
  const float rely = r.oy + r.dy * tt - r0.y;
  const float relz = r.oz + r.dz * tt - r0.z;
  a = relx * r1.z + rely * r1.w + relz * r2.x;
  b = relx * r2.y + rely * r2.z + relz * r2.w;
  return ok && tt > t_min && tt < best && a >= 0.0f && a <= 1.0f && b >= 0.0f && b <= 1.0f;
}

// triangle: v0(3) e1(3) e2(3) normal(3), then uv0(2) uv1(2) uv2(2)
__device__ __forceinline__ bool tri_test16(const float4* __restrict__ q, const Ray& r,
                                           float t_min, float best, float& tt, float& bu,
                                           float& bv, float4& r2) {
  const float4 r0 = q[0], r1 = q[1];
  r2 = q[2];
  return moller_trumbore(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x, r, t_min, best,
                         tt, bu, bv);
}

// closest_hit over the records: the same winner, normal and UV
__device__ __forceinline__ Hit closest_hit16(const float4* __restrict__ rec, const RecLayout& R,
                                             const Ray& r, float t_min, float bound) {
  Hit h;
  h.t = bound;
  h.prim = -1;
  h.nx = h.ny = h.nz = h.u = h.v = 0.0f;
  float tt, p, q, s;
  float4 x0, x1, x3;

  const float4* f = rec + R.pb;
  for (int i = 0; i < R.P; ++i, f += kPlaneRec / 4) {
    if (plane_test16(f, r, t_min, h.t, tt, p, q, x0, x1, x3)) {
      h.t = tt;
      h.prim = i;
      h.nx = x0.w;
      h.ny = x1.x;
      h.nz = x1.y;
      h.u = p / x3.x;
      h.v = q / x3.y;
    }
  }
  f = rec + R.sb;
  for (int i = 0; i < R.S; ++i, f += kSphereRec / 4) {
    const float4 c = f[0];
    if (sphere_test16(c, r, t_min, h.t, tt)) {
      const float inv_r = 1.0f / (c.w > 0.0f ? c.w : 1.0f);
      h.t = tt;
      h.prim = R.P + i;
      h.nx = (r.ox + r.dx * tt - c.x) * inv_r;
      h.ny = (r.oy + r.dy * tt - c.y) * inv_r;
      h.nz = (r.oz + r.dz * tt - c.z) * inv_r;
      h.u = 0.0f;  // sphere UVs fixed at 0 (reference quirk 3)
      h.v = 0.0f;
    }
  }
  f = rec + R.qb;
  for (int i = 0; i < R.Q; ++i, f += kQuadRec / 4) {
    if (quad_test16(f, r, t_min, h.t, tt, s, p, q, x0, x1)) {
      const float sgn = s > 0.0f ? -1.0f : 1.0f;  // flip toward the ray
      const float4 uv = f[3], uvb = f[4];
      h.t = tt;
      h.prim = R.P + R.S + i;
      h.nx = sgn * x0.w;
      h.ny = sgn * x1.x;
      h.nz = sgn * x1.y;
      h.u = uv.x + p * uv.z + q * uvb.x;
      h.v = uv.y + p * uv.w + q * uvb.y;
    }
  }
  f = rec + R.tb;
  for (int i = 0; i < R.T; ++i, f += kTriRec / 4) {
    if (tri_test16(f, r, t_min, h.t, tt, p, q, x0)) {
      const float tnx = x0.y, tny = x0.z, tnz = x0.w;
      const float sgn = r.dx * tnx + r.dy * tny + r.dz * tnz > 0.0f ? -1.0f : 1.0f;
      const float bw = 1.0f - p - q;
      const float4 uv = f[3], uv2 = f[4];
      h.t = tt;
      h.prim = R.P + R.S + R.Q + i;
      h.nx = sgn * tnx;
      h.ny = sgn * tny;
      h.nz = sgn * tnz;
      h.u = bw * uv.x + p * uv.z + q * uv2.x;
      h.v = bw * uv.y + p * uv.w + q * uv2.y;
    }
  }
  return h;
}

// any_hit over the records: stops at the first occluder, as any_hit does
__device__ __forceinline__ bool any_hit16(const float4* __restrict__ rec, const RecLayout& R,
                                          const Ray& r, float t_min, float bound) {
  float tt, p, q, s;
  float4 x0, x1, x3;
  const float4* f = rec + R.pb;
  for (int i = 0; i < R.P; ++i, f += kPlaneRec / 4)
    if (plane_test16(f, r, t_min, bound, tt, p, q, x0, x1, x3)) return true;
  f = rec + R.sb;
  for (int i = 0; i < R.S; ++i, f += kSphereRec / 4)
    if (sphere_test16(f[0], r, t_min, bound, tt)) return true;
  f = rec + R.qb;
  for (int i = 0; i < R.Q; ++i, f += kQuadRec / 4)
    if (quad_test16(f, r, t_min, bound, tt, s, p, q, x0, x1)) return true;
  f = rec + R.tb;
  for (int i = 0; i < R.T; ++i, f += kTriRec / 4)
    if (tri_test16(f, r, t_min, bound, tt, p, q, x0)) return true;
  return false;
}

}  // namespace ptrt
