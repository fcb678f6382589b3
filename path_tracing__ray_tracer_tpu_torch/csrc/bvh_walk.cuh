// Per-thread BVH4 walks over the triangles, closest hit and occlusion.
//
// Replaces the walk bodies of the JAX package's ops/pallas/bvh_pallas.py,
// _bvh4_walk and _bvh4_any_walk (with _quad_pop_common, _quad_push_order,
// _leaf_tris and _slab), which the TPU kernels _bvh4_scene_closest_kernel,
// _bvh4_scene_any_kernel (K4a, K4b) and bounce_bvh_pallas.py's
// _path_bounce_bvh_kernel (K5) share.  On the TPU a block of 1,024 rays walks
// the tree together from SMEM, steered by block-wide any-bits and a
// coherence sort; here each thread walks its own ray with its own stack over
// the records in device memory (read through the read-only cache), so no
// sort is needed and no lane tests a box only its neighbours hit.
//
// Kept exactly, per lane: the slab test and the Möller–Trumbore test of
// ops/bvh.py (strict `<` against the running best, t > t_min, the 1e-12 and
// 1e-6 guards); at each pop the four child boxes are tested against the best
// at pop time, the leaf children are tested in child order, and the inner
// children are pushed far to near by the node's three split codes.  Near and
// far come from the lane's own direction (the TPU kernel takes the sign
// majority of its block).  So a lane's winner equals the plain skip-link
// walk's, except between triangles at exactly equal t, which the two visit
// orders may break differently.
//
// Records (ops/bvh.py): node record, 32 floats: child c's box lo at 6c, hi
// at 6c + 3; child metas at 24 + c (leaf: its first slot >= 0; inner:
// -(1 + node index); empty: -1 with a never-hit box); split codes at 28-30.
// Slot record, 13 floats: v0, e1, e2, gid (-1 padding; uid << 17 | tri
// when packed), the stored unit normal.
//
// The leaf visit is a compile-time policy.  SlotLeaf tests the 16 slot
// records by Möller–Trumbore, reading each slot's floats as the test needs
// them (the top walks K6a/K6b, over their block's copy in shared memory or
// from device memory).  Slot16Leaf is SlotLeaf over a port-only copy of the
// slot records padded to 16 floats (64 B, 16-byte aligned; ops/bvh.py
// pack_slot16 and, per page, pack_page_slot16), read as 16-byte loads, a
// batch of slots at a time (K4a, K4b, K5, K6c/K6d, K4c/K4d; Slot16TriLeaf:
// the same, for walks that keep only t and the triangle).  MatQuadLeaf
// (K10a-d; the JAX package's MXU leaf visit _leaf_closest_mxu /
// _leaf_any_mxu) evaluates the same decision quantities as linear forms of
// the lane's ray features f = [d, m = o×d, o, 1] (MatLeaf) over the leaf's
// columns of the coefficient table (ops/bvh.py pack_leaf_mat: 16 feature
// rows of stride G·128 floats; leaf g at column 128g, quantity q at +16q,
// slot k at +k: det | u·det | v·det | t·det | nx | ny | nz | gid, the last
// four on the constant row 9), read as 16-byte loads over four slots, a
// batch at a time.  Each form adds its feature rows' products in increasing
// row order, as the plain version does (ops/bvh.py _forms), so the two
// agree bit for bit; the decisions are division free (with s2 = det²,
// u ≥ 0 ⇔ u·det·det ≥ 0), and t = t·det / det, u and v one division each.
//
// The node records' source is a compile-time policy too.  Vec4Nodes reads
// the whole 128 B record as eight 16-byte loads into registers, from device
// memory or from a copy of the node table in shared memory (K4b and K5, and
// the top walks K6a/K6b, either way; K4a, the page walks K6c/K6d and
// K4c/K4d, the rooted walk K11 and K10a-d, from device memory).  The stack
// is a per-thread array in local memory (LocalStack), sized by the walk's
// depth class.  None of the policies changes a lane's arithmetic or its
// visit order.
//
// The paged layout's top tree (ops/bvh.py pack_paged; the JAX package's
// bvh_paged_pallas.py) adds a fourth kind of child: a page, meta
// -(1 + PAGE_META_BASE + page).  The walks instantiated with kPaged = true
// never push a page: a lane whose slab test enters its box sets the page's
// bit in its two-word pending mask, as _paged_top_walk does.  Both walks take
// the lane's best so far in and out, so the same body walks the top tree and
// then each pending page (bvh_paged.cu).
#pragma once

#include "sweep.cuh"

namespace ptrt {

constexpr int kNode4F = 32;
constexpr int kSlotF = 13;
constexpr int kSlot16F = 16;  // the padded slot record of Slot16Leaf
constexpr int kLeafSize = 16;
// deepest BVH4 the walk takes: the stack never holds more than 3 * depth - 2
// nodes (ops/cuda/bvh.py checks the depth before it launches)
constexpr int kMaxDepth4 = 32;
// the persistent walks' block (ops/cuda/bvh.py WALK_THREADS) and their two
// depth classes: a BVH4 at most kShallow4 deep takes a stack of
// 3 * kShallow4 - 2 entries, any other one 3 * kMaxDepth4 - 2
constexpr int kWalkThreads = 256;
constexpr int kShallow4 = 8;
__host__ __device__ constexpr int stack_cap(int depth_class) { return 3 * depth_class - 2; }
constexpr int kGidUidBits = 17;
// a child meta at or below kPageMeta0 names page -(meta) - 1 - kPageMetaBase
constexpr int kPageMetaBase = 1 << 20;
constexpr float kPageMeta0 = -(float)(1 + kPageMetaBase);
constexpr int kGidTriMask = (1 << kGidUidBits) - 1;

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) > 1e-12f ? d : 1e-12f);
}

struct WalkRay {
  Ray r;
  float ivx, ivy, ivz;
};

__device__ __forceinline__ WalkRay walk_ray(const Ray& r) {
  return WalkRay{r, inv_dir(r.dx), inv_dir(r.dy), inv_dir(r.dz)};
}

__device__ __forceinline__ bool slab(const float* __restrict__ b, const WalkRay& w, float t_min,
                                     float far) {
  float a = (b[0] - w.r.ox) * w.ivx, c = (b[3] - w.r.ox) * w.ivx;
  const float tx0 = fminf(a, c), tx1 = fmaxf(a, c);
  a = (b[1] - w.r.oy) * w.ivy;
  c = (b[4] - w.r.oy) * w.ivy;
  const float ty0 = fminf(a, c), ty1 = fmaxf(a, c);
  a = (b[2] - w.r.oz) * w.ivz;
  c = (b[5] - w.r.oz) * w.ivz;
  const float tz0 = fminf(a, c), tz1 = fmaxf(a, c);
  const float enter = fmaxf(fmaxf(tx0, ty0), fmaxf(tz0, t_min));
  const float exit = fminf(fminf(tx1, ty1), fminf(tz1, far));
  return enter <= exit;
}

// does the child whose split code is `code` put its left half nearer?
__device__ __forceinline__ bool near_first(float code, const Ray& r) {
  const int k = (int)code;
  const int axis = k & 3;
  const float d = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
  return (d > 0.0f) != (k >= 4);
}

// A lane's pending pages: bit p of (lo, hi) as one 64-bit mask.
struct Pend {
  unsigned lo, hi;
};

// Set the pending bits of the page children of node record `b` that the lane
// entered (the slab tests at pop time, as the JAX top walk takes them).
__device__ __forceinline__ void pend_pages(const bool* hit, const float* meta, Pend& pend) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!(hit[c] && meta[c] <= kPageMeta0)) continue;
    const int pg = (int)(-meta[c]) - 1 - kPageMetaBase;
    if (pg < 32) pend.lo |= 1u << pg;
    else pend.hi |= 1u << (pg - 32);
  }
}

// ---- node sources --------------------------------------------------------
// rec(node, buf) returns the node's 32 floats: buf filled by eight 16-byte
// loads.
template <bool kShared>
struct Vec4Nodes {
  const float4* q;  // device memory (read through the read-only cache) or shared memory

  __device__ __forceinline__ const float* rec(int node, float (&buf)[kNode4F]) const {
    const float4* p = q + (size_t)node * (kNode4F / 4);
#pragma unroll
    for (int k = 0; k < kNode4F / 4; ++k) {
      const float4 v = kShared ? p[k] : __ldg(p + k);
      buf[4 * k] = v.x;
      buf[4 * k + 1] = v.y;
      buf[4 * k + 2] = v.z;
      buf[4 * k + 3] = v.w;
    }
    return buf;
  }
};

// ---- stacks ---------------------------------------------------------------
template <int kCap>
struct LocalStack {
  int s[kCap];
  int sp = 0;

  __device__ __forceinline__ void push(int v) { s[sp++] = v; }
  __device__ __forceinline__ int pop() { return s[--sp]; }
  __device__ __forceinline__ bool empty() const { return sp == 0; }
};

// Push the hit inner children of node record `b`, the farthest first (never
// a page of a paged top tree).  An inner child's meta is -(1 + node) with
// node >= 1 (the root is no one's child), so meta < -1; an empty child's -1
// is never pushed.  Its point box at +3e38 is missed by every ray with a
// finite bound, but a ray with an infinite bound can enter it (each of its
// slabs overflows to +inf), and pushing -1 would push the root again: the
// walk then repeats, and overruns the 3 * depth - 2 entries its stack holds.
template <bool kPaged, class Stack>
__device__ __forceinline__ void push_children(const float* __restrict__ b, const bool* hit,
                                              const float* meta, const Ray& r, Stack& stack) {
  const bool p0n = near_first(b[28], r);  // the left pair is the near one
  const bool c0n = near_first(b[29], r);  // child 0 is the near one of the left pair
  const bool c2n = near_first(b[30], r);  // child 2 is the near one of the right pair
  const int l_near = c0n ? 0 : 1, l_far = c0n ? 1 : 0;
  const int r_near = c2n ? 2 : 3, r_far = c2n ? 3 : 2;
  const int order[4] = {p0n ? r_far : l_far, p0n ? r_near : l_near, p0n ? l_far : r_far,
                        p0n ? l_near : r_near};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = order[j];
    if (hit[c] && meta[c] < -1.0f && (!kPaged || meta[c] > kPageMeta0))
      stack.push((int)(-meta[c]) - 1);
  }
}

// The 16 slot records of the leaf whose first slot is `base`, by
// Möller–Trumbore: the first slot with the least t below h.t wins.
struct SlotLeaf {
  const float* __restrict__ slots;

  __device__ __forceinline__ void closest(float base, const Ray& r, float t_min, int gid_offset,
                                          Hit& h) const {
    const float* s = slots + (size_t)base * kSlotF;
    for (int k = 0; k < kLeafSize; ++k, s += kSlotF) {
      float tt, bu, bv;
      if (moller_trumbore(s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], r, t_min, h.t, tt,
                          bu, bv) &&
          s[9] >= 0.0f) {
        h.t = tt;
        h.prim = (int)s[9] + gid_offset;
        h.u = bu;
        h.v = bv;
        h.nx = s[10];
        h.ny = s[11];
        h.nz = s[12];
      }
    }
  }

  __device__ __forceinline__ bool any(float base, const Ray& r, float t_min, float limit) const {
    const float* s = slots + (size_t)base * kSlotF;
    for (int k = 0; k < kLeafSize; ++k, s += kSlotF) {
      float tt, bu, bv;
      if (moller_trumbore(s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], r, t_min, limit,
                          tt, bu, bv) &&
          s[9] >= 0.0f)
        return true;
    }
    return false;
  }
};

// SlotLeaf over the padded records: v0 e1x | e1y e1z e2x e2y | e2z gid nx ny |
// nz 0 0 0.  A leaf is read kSlotBatch slots at a time: their three 16-byte
// loads each are issued together before the batch's tests, which then run
// in slot order, so a lane waits on device memory once a batch and not once
// a slot.  The last word is read on a win.  kAttrs false: a win keeps only t
// and the gid (the triangle-only walks that emit (t, tri) or occlusion: K11,
// K4e), so no attribute is read or carried; the winner is the same.
constexpr int kSlotBatch = 4;

template <bool kAttrs>
struct Slot16LeafT {
  const float4* __restrict__ slots;

  __device__ __forceinline__ void load(const float4* s, float4 (&a)[kSlotBatch],
                                       float4 (&b)[kSlotBatch], float4 (&c)[kSlotBatch]) const {
#pragma unroll
    for (int j = 0; j < kSlotBatch; ++j) {
      a[j] = __ldg(s + 4 * j);
      b[j] = __ldg(s + 4 * j + 1);
      c[j] = __ldg(s + 4 * j + 2);
    }
  }

  __device__ __forceinline__ void closest(float base, const Ray& r, float t_min, int gid_offset,
                                          Hit& h) const {
    const float4* s = slots + (size_t)base * (kSlot16F / 4);
    for (int k = 0; k < kLeafSize; k += kSlotBatch, s += kSlotBatch * (kSlot16F / 4)) {
      float4 a[kSlotBatch], b[kSlotBatch], c[kSlotBatch];
      load(s, a, b, c);
#pragma unroll
      for (int j = 0; j < kSlotBatch; ++j) {
        float tt, bu, bv;
        if (moller_trumbore(a[j].x, a[j].y, a[j].z, a[j].w, b[j].x, b[j].y, b[j].z, b[j].w,
                            c[j].x, r, t_min, h.t, tt, bu, bv) &&
            c[j].y >= 0.0f) {
          h.t = tt;
          h.prim = (int)c[j].y + gid_offset;
          if constexpr (kAttrs) {
            h.u = bu;
            h.v = bv;
            h.nx = c[j].z;
            h.ny = c[j].w;
            h.nz = __ldg(&s[4 * j + 3].x);
          }
        }
      }
    }
  }

  __device__ __forceinline__ bool any(float base, const Ray& r, float t_min, float limit) const {
    const float4* s = slots + (size_t)base * (kSlot16F / 4);
    for (int k = 0; k < kLeafSize; k += kSlotBatch, s += kSlotBatch * (kSlot16F / 4)) {
      float4 a[kSlotBatch], b[kSlotBatch], c[kSlotBatch];
      load(s, a, b, c);
#pragma unroll
      for (int j = 0; j < kSlotBatch; ++j) {
        float tt, bu, bv;
        if (moller_trumbore(a[j].x, a[j].y, a[j].z, a[j].w, b[j].x, b[j].y, b[j].z, b[j].w,
                            c[j].x, r, t_min, limit, tt, bu, bv) &&
            c[j].y >= 0.0f)
          return true;
      }
    }
    return false;
  }
};

using Slot16Leaf = Slot16LeafT<true>;
using Slot16TriLeaf = Slot16LeafT<false>;

// The lane's ray features over the leaf coefficient table: f = [d, m = o × d,
// o, 1], the table's feature rows (ops/bvh.py leaf_features), computed once a
// walk in registers.
struct MatLeaf {
  const float* __restrict__ mat;
  size_t stride;  // G · 128, the floats of one feature row
  float f[10];

  __device__ __forceinline__ MatLeaf(const float* __restrict__ m, size_t row_stride, const Ray& r)
      : mat(m), stride(row_stride) {
    f[0] = r.dx; f[1] = r.dy; f[2] = r.dz;
    f[3] = r.oy * r.dz - r.oz * r.dy;  // m = o × d
    f[4] = r.oz * r.dx - r.ox * r.dz;
    f[5] = r.ox * r.dy - r.oy * r.dx;
    f[6] = r.ox; f[7] = r.oy; f[8] = r.oz; f[9] = 1.0f;
  }
};

// The leaf-table visits of K10a-d: the forms over MatLeaf's features with the
// table read as 16-byte loads, each over four consecutive slots of one
// (feature row, quantity): the row stride (128·G floats) and the column
// offsets (128g + 16q + k, k a multiple of 4) are multiples of 4 floats, so
// every such load is aligned.  A batch of kSlotBatch = 4 slots is the 19 loads
// of its coefficients (det's rows 0-2, u·det's and v·det's rows 0-5, t·det's
// rows 6-9), issued before the batch's tests, which then run in slot order;
// the first designs' visit issued a 4-byte load per coefficient as a form
// needed it (in git at 41c504a, MatLeaf::closest).  Both visits issue a
// batch's 15 loads of det, u·det and v·det, run its four slots' inside tests,
// and only when a slot is inside issue the four of t·det.  The closest visit
// (K10a, K10c) then tests the inside slots in order against the running best
// and reads the gid and the normal for the leaf's winner only; the occlusion
// visit (K10b, K10d) returns at the batch's first hit.  Each form adds its
// products in increasing row order and each decision is the first designs'
// (MatLeaf::closest at 41c504a, MatLeaf::any at 359e47e), expression for
// expression, so a lane's record and verdict are bit for bit theirs.  (Measured
// on an H100 and not kept, PERF.md: a slot-major copy of the 19 coefficients,
// 96 B a slot, 1.58 MB for config 5 against the table's 8.45 MB, read as five
// 16-byte loads a slot, within 3% of the closest visit; and either visit
// issuing all 19 loads of a batch together, the occlusion visit 7-12% slower
// and the closest visit 8-14%.)
struct MatQuadLeaf : MatLeaf {
  using MatLeaf::MatLeaf;  // the table, its row stride and the lane's features

  // Σ c[at + row − r0] · f[row] over rows [r0, r1), in increasing row order
  __device__ __forceinline__ float form(const float* c, int at, int r0, int r1) const {
    float acc = c[at] * f[r0];
#pragma unroll
    for (int r = r0 + 1; r < r1; ++r) acc = acc + c[at + r - r0] * f[r];
    return acc;
  }

  // The loads of slots k..k+3 of the leaf whose columns start at col0, a
  // slot's coefficients in component j of each for slot k + j: load_uv issues
  // det's, u·det's and v·det's 15 into v[0..2], v[3..8], v[9..14]; load_t
  // t·det's four into v[15..18].
  __device__ __forceinline__ const float4* at(const float* col0, int k, int q, int row) const {
    static_assert(kSlotBatch == 4, "one 16-byte load spans four slots");
    return reinterpret_cast<const float4*>(col0 + 16 * q + k + (size_t)row * stride);
  }

  __device__ __forceinline__ void load_uv(const float* col0, int k, float4 (&v)[19]) const {
#pragma unroll
    for (int r = 0; r < 3; ++r) v[r] = __ldg(at(col0, k, 0, r));
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      v[3 + r] = __ldg(at(col0, k, 1, r));
      v[9 + r] = __ldg(at(col0, k, 2, r));
    }
  }

  __device__ __forceinline__ void load_t(const float* col0, int k, float4 (&v)[19]) const {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[15 + r] = __ldg(at(col0, k, 3, 6 + r));
  }

  // Slot j of a batch: its det, u·det, v·det and det² from v[0..14];
  // returns the inside test: |det| > 1e-6 and (u, v) in the triangle.
  __device__ __forceinline__ bool uv_inside(const float4 (&v)[19], int j, float& det, float& un,
                                            float& vn, float& s2) const {
    float c[15];
#pragma unroll
    for (int x = 0; x < 15; ++x)
      c[x] = j == 0 ? v[x].x : (j == 1 ? v[x].y : (j == 2 ? v[x].z : v[x].w));
    det = form(c, 0, 0, 3);
    un = form(c, 3, 0, 6);
    vn = form(c, 9, 0, 6);
    s2 = det * det;
    const float ud = un * det, vd = vn * det;
    return fabsf(det) > 1e-6f && ud >= 0.0f && ud <= s2 && vd >= 0.0f && ud + vd <= s2;
  }

  // Slot j's t·det from v[15..18].
  __device__ __forceinline__ float t_det(const float4 (&v)[19], int j) const {
    float c[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 q = v[15 + x];
      c[x] = j == 0 ? q.x : (j == 1 ? q.y : (j == 2 ? q.z : q.w));
    }
    return form(c, 0, 6, 10);
  }

  // The least t in (t_min, h.t) of the leaf's slots wins, ties to the lowest
  // slot: _leaf_closest_mxu's per-visit minimum kept below the running best,
  // which the sequential strict-`<` scan gives.  A batch's four t·det loads
  // are issued only when one of its slots is inside its triangle.
  __device__ __forceinline__ void closest(float base, const Ray&, float t_min, int gid_offset,
                                          Hit& h) const {
    const float* col0 = mat + (size_t)base / kLeafSize * 128;
    int won = -1;
    for (int k = 0; k < kLeafSize; k += kSlotBatch) {
      float4 v[19];
      load_uv(col0, k, v);
      float det[kSlotBatch], un[kSlotBatch], vn[kSlotBatch];
      bool inside[kSlotBatch], some = false;
#pragma unroll
      for (int j = 0; j < kSlotBatch; ++j) {
        float s2;
        inside[j] = uv_inside(v, j, det[j], un[j], vn[j], s2);
        some = some || inside[j];
      }
      if (!some) continue;
      load_t(col0, k, v);
#pragma unroll
      for (int j = 0; j < kSlotBatch; ++j) {
        if (!inside[j]) continue;
        const float t = t_det(v, j) / det[j];
        if (t > t_min && t < h.t) {
          h.t = t;
          h.u = un[j] / det[j];
          h.v = vn[j] / det[j];
          won = k + j;
        }
      }
    }
    if (won >= 0) {
      const float* c9 = col0 + won + 9 * stride;
      h.prim = (int)__ldg(c9 + 112) + gid_offset;
      h.nx = __ldg(c9 + 64);
      h.ny = __ldg(c9 + 80);
      h.nz = __ldg(c9 + 96);
    }
  }

  // Any slot hit with t_min·det² < t·det·det < limit·det², the slots tested
  // in order.  A batch's four t·det loads are issued only when one of its
  // slots is inside its triangle: a batch no slot of which is inside reads
  // 15 of its 19 loads.  An infinite limit keeps the first design's verdict:
  // a slot inside its triangle with t·det·det > t_min·det² occludes.
  __device__ __forceinline__ bool any(float base, const Ray&, float t_min, float limit) const {
    const float* col0 = mat + (size_t)base / kLeafSize * 128;
    for (int k = 0; k < kLeafSize; k += kSlotBatch) {
      float4 v[19];
      load_uv(col0, k, v);
      float det[kSlotBatch], s2[kSlotBatch];
      bool inside[kSlotBatch], some = false;
#pragma unroll
      for (int j = 0; j < kSlotBatch; ++j) {
        float un, vn;
        inside[j] = uv_inside(v, j, det[j], un, vn, s2[j]);
        some = some || inside[j];
      }
      if (!some) continue;
      load_t(col0, k, v);
#pragma unroll
      for (int j = 0; j < kSlotBatch; ++j) {
        if (!inside[j]) continue;
        const float td = t_det(v, j) * det[j];
        if (td > t_min * s2[j] && td < limit * s2[j]) return true;
      }
    }
    return false;
  }
};

// Closest hit below h.t among the triangles; h carries the best so far in
// (the plane/sphere/quad winner, or an earlier page's or pass's) and the
// winner out: t, prim = gid + gid_offset (gid still packed), the raw
// barycentrics as u, v and the stored (unflipped) normal.  kPaged: a top
// tree, whose page children set bits of `pend` instead of being walked.
// `root`: the node the walk starts from (a subtree's, in a multipass pass).
// `nodes`, `leaf`, `stack`: the node source, the leaf visit (SlotLeaf,
// Slot16Leaf or MatQuadLeaf) and an empty stack.
template <bool kPaged, class Nodes, class Leaf, class Stack>
__device__ __forceinline__ void walk_closest_with(const Nodes& nodes, int n_nodes,
                                                  const Leaf& leaf, Stack& stack, const Ray& r,
                                                  float t_min, int gid_offset, Hit& h,
                                                  Pend* pend, int root = 0) {
  const WalkRay w = walk_ray(r);
  stack.push(root);
  for (int step = 0; !stack.empty() && step < n_nodes + 2; ++step) {
    float buf[kNode4F];
    const float* b = nodes.rec(stack.pop(), buf);
    bool hit[4];
    float meta[4];
    const float far = h.t;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      hit[c] = slab(b + 6 * c, w, t_min, far);
      meta[c] = b[24 + c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (hit[c] && meta[c] >= 0.0f) leaf.closest(meta[c], r, t_min, gid_offset, h);
    if constexpr (kPaged) pend_pages(hit, meta, *pend);
    push_children<kPaged>(b, hit, meta, r, stack);
  }
}

// Is any triangle hit in (t_min, limit)?  Stops at the first one; the page
// bits set before it stay set.
template <bool kPaged, class Nodes, class Leaf, class Stack>
__device__ __forceinline__ bool walk_any_with(const Nodes& nodes, int n_nodes, const Leaf& leaf,
                                              Stack& stack, const Ray& r, float t_min,
                                              float limit, Pend* pend) {
  const WalkRay w = walk_ray(r);
  stack.push(0);
  for (int step = 0; !stack.empty() && step < n_nodes + 2; ++step) {
    float buf[kNode4F];
    const float* b = nodes.rec(stack.pop(), buf);
    bool hit[4];
    float meta[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      hit[c] = slab(b + 6 * c, w, t_min, limit);
      meta[c] = b[24 + c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (hit[c] && meta[c] >= 0.0f && leaf.any(meta[c], r, t_min, limit)) return true;
    if constexpr (kPaged) pend_pages(hit, meta, *pend);
    push_children<kPaged>(b, hit, meta, r, stack);
  }
  return false;
}

// Lane i's ray from the six component arrays.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ ox, const float* __restrict__ oy,
                                        const float* __restrict__ oz, const float* __restrict__ dx,
                                        const float* __restrict__ dy, const float* __restrict__ dz,
                                        int i) {
  Ray r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  return r;
}

// ---- the persistent walks' block set-up ------------------------------------
// Dynamic shared memory of a persistent walk: the BVH4 node table when it is
// staged, then the kernel's own tables.  The bytes before the tables:
__host__ __device__ inline size_t tree_smem_bytes(int stage, int n_nodes) {
  return stage ? sizeof(float) * (size_t)n_nodes * kNode4F : 0;
}

// Lift a persistent walk's dynamic shared memory limit to `smem` bytes where
// it is lower (a launch above 48 KB needs it); never lowers it, so a launch
// allowed before stays allowed.
template <class K>
inline cudaError_t allow_smem(K kernel, int smem) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess && smem > a.maxDynamicSharedSizeBytes)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err;
}

// Resident blocks per SM of a persistent walk that stages nothing (stage
// and smem must be 0), into *blocks; nullptr (no such variant) is refused.
template <class K>
inline int walk_occupancy(K kernel, int stage, int smem, int* blocks) {
  if (kernel == nullptr || stage != 0 || smem != 0) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kWalkThreads, 0);
}

// Resident blocks per SM of a persistent walk that stages no tree, only
// `smem` bytes of its own tables (stage must be 0), into *blocks; first
// lifts the kernel's dynamic shared memory limit to `smem` where it is lower.
// nullptr (no such variant) is refused.
template <class K>
inline int table_occupancy(K kernel, int stage, int smem, int* blocks) {
  if (kernel == nullptr || stage != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kWalkThreads, smem);
  return (int)err;
}

// The plane/sphere/quad blob's bytes (sweep.cuh's layout with no triangles).
inline size_t blob_bytes(int P, int S, int Q) {
  return sizeof(float) * (size_t)(14 * P + 4 * S + 18 * Q);
}

// Copy the plane/sphere/quad blob (`size` floats, 14P + 4S + 18Q) into the
// block's shared memory `ps`, once per resident block, and wait for it.
__device__ __forceinline__ void stage_blob(float* ps, const float* __restrict__ ps_g, int size) {
  for (int k = threadIdx.x; k < size; k += blockDim.x) ps[k] = ps_g[k];
  __syncthreads();
}

// One bulk copy (TMA) of `bytes` from device memory into shared memory,
// completing on the mbarrier `bar`; called by one thread.  Both addresses
// are 16-byte aligned and `bytes` is a multiple of 16 (node records are
// 128 B; ops/cuda/bvh.py checks the table's alignment).
__device__ __forceinline__ void bulk_copy_start(void* dst, const void* src, uint32_t bytes,
                                                uint64_t* bar) {
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(d), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(b)
      : "memory");
}

// Wait for the copy's phase (0) of `bar` to complete; every thread calls it
// after a __syncthreads() that follows bulk_copy_start.
__device__ __forceinline__ void bulk_copy_wait(uint64_t* bar) {
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
  } while (!done);
}

// The persistent loop's next lane (Aila & Laine's persistent threads): lane
// 0 of each warp takes the next 32 lanes from counter[0] for the whole warp,
// which runs until the slowest of them ends.  The loop ends when a warp's
// batch starts at or past n.
__device__ __forceinline__ int next_lane(int* counter) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(counter, 32);
  return __shfl_sync(0xffffffffu, base, 0) + lane;
}

// The next lane of a persistent loop whose first batch is static: a thread
// starts at lane blockIdx.x * blockDim.x + threadIdx.x of the grid's span of
// gridDim.x * blockDim.x lanes, and its warp takes its later batches past
// the span from counter[0] (next_lane).  When the span covers all n lanes
// there is no later batch and no thread touches the counter, so the kernel
// calls finish_lanes only when span < n.
__device__ __forceinline__ int next_batch(int* counter, int span, int n) {
  return span < n ? span + next_lane(counter) : n + (int)(threadIdx.x & 31);
}

// Every thread of a block calls this after its persistent loop.  The last
// block to get here zeroes counter[0] (the next lane) and counter[1] (the
// blocks done): every other block has taken its last batch by then, and the
// next launch on the stream starts from lane 0 with no memset.
__device__ __forceinline__ void finish_lanes(int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(counter + 1, 1) == (int)gridDim.x - 1) {
      atomicExch(counter, 0);
      atomicExch(counter + 1, 0);
    }
  }
}

// A triangle winner's global id without its packed uid; other ids unchanged.
// gid_mask: kGidTriMask when the slot gids carry uids, else -1 (every bit: a
// plain id may exceed 17 bits).
__device__ __forceinline__ int decode_prim(int prim, int gid_offset,
                                           int gid_mask = kGidTriMask) {
  return prim >= gid_offset ? ((prim - gid_offset) & gid_mask) + gid_offset : prim;
}

// The record the scene walks emit: a triangle winner's id decoded and its
// stored normal flipped toward the ray.  Both steps are idempotent, so a
// finished record may be carried into a further walk and finished again.
__device__ __forceinline__ void finish_hit(Hit& h, const Ray& r, int gid_offset, int gid_mask) {
  h.prim = decode_prim(h.prim, gid_offset, gid_mask);
  if (h.prim >= gid_offset && h.nx * r.dx + h.ny * r.dy + h.nz * r.dz > 0.0f) {
    h.nx = -h.nx; h.ny = -h.ny; h.nz = -h.nz;
  }
}

// The whole-scene closest walks' lanes (K4a, K10a), one lane a thread: the
// plane/sphere/quad sweep over the block's copy of the blob `ps` seeds the
// BVH4 walk (nodes by `nodes`, leaves by `leaf_of(ray)`, a stack of the depth
// class kClass), then the record is finished and written.  Lanes [0, n): a
// static first batch, later ones from `counter` (next_batch; two int32, zero
// at the launch, left zero).  Each lane's floats and visit order are the
// first designs' (one thread a lane in blocks of 128; in git at 41c504a).
template <int kClass, class Nodes, class LeafOf>
__device__ __forceinline__ void scene_closest_lanes(
    const float* ps, const SceneLayout& L, const Nodes& nodes, int n_nodes, const LeafOf& leaf_of,
    const float* __restrict__ ox, const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy, const float* __restrict__ dz,
    int n, int gid_mask, float t_min, float t_max, float* __restrict__ t_out,
    int* __restrict__ prim_out, float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ nx_out, float* __restrict__ ny_out, float* __restrict__ nz_out,
    int* __restrict__ counter) {
  const int off = L.P + L.S + L.Q;
  const int lane = threadIdx.x & 31;
  const int span = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;; i = next_batch(counter, span, n)) {
    if (i - lane >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
    Hit h = closest_hit(ps, L, r, t_min, t_max);
    LocalStack<stack_cap(kClass)> stack;
    walk_closest_with<false>(nodes, n_nodes, leaf_of(r), stack, r, t_min, off, h, nullptr);
    finish_hit(h, r, off, gid_mask);  // slot normals are stored unflipped
    t_out[i] = h.t;
    prim_out[i] = h.prim;
    u_out[i] = h.u;
    v_out[i] = h.v;
    nx_out[i] = h.nx;
    ny_out[i] = h.ny;
    nz_out[i] = h.nz;
  }
  if (span < n) finish_lanes(counter);
}

}  // namespace ptrt
