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

}  // namespace ptrt
