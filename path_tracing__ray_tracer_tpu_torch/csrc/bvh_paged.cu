// The two-level (paged) BVH walk, one ray per thread: the top walk (K6a
// closest, K6b occlusion) and the walk of each lane's pending pages (K6c
// closest, K6d occlusion).  Over the whole one-level tree as a single page
// with every lane on, K6c and K6d are the triangle-only BVH4 walks (K4c,
// K4d), the carried best seeded with a per-ray bound.
//
// Replaces the JAX package's ops/pallas/bvh_paged_pallas.py::
// _paged_top_closest_kernel, _paged_top_any_kernel, _page_closest_kernel and
// _page_any_kernel (entered there through bvh_paged_scene_closest_pallas and
// bvh_paged_scene_any_pallas), and ops/pallas/bvh_pallas.py::
// _bvh4_closest_attrs_kernel, _bvh4_closest_kernel and _bvh4_any_kernel (the
// same _bvh4_walk / _bvh4_any_walk bodies over the whole tree).
//
// On the TPU the tree must sit in SMEM, so a big one is cut into pages of at
// most ~200K floats; the top kernel emits per-lane pending-page masks and the
// wrapper launches one rooted walk per page (after a coherence sort, a
// root-box cull and a skip of pages no lane needs).  Here every page sits in
// device memory and each thread walks its own ray, so one launch walks all of
// a lane's pending pages in increasing index: 2 launches per query instead of
// 1 + n_pages, and no host decision per page.  Kept exactly, per lane: the
// slab and Möller–Trumbore tests of bvh_walk.cuh, strict `<` against the
// carried best, pages in increasing index, and the cull of _page_root_slab
// (the page root's box against the carried best) before each page.  So a
// lane's winner equals the composition of the JAX per-page launches.
//
// What bounds them: latency, as K4a (dependent node and slot loads from
// device memory, one ray per thread).  Per ray K6a reads 24 B and writes 36 B,
// K6c reads 60 B and writes 28 B, K6b reads 28 B and writes 9 B, K6d reads
// 29 B and writes 1 B.  The design keeps it simple: the records as packed,
// only the plane/sphere/quad blob in shared memory (K6a, K6b).
//
// Records: the top tree and top slots as bvh_walk.cuh's, page children
// marked by their metas; page p's BVH4 records at page_tree + p * tc and its
// slot records at page_slot + p * sc; its root box at page_lo/page_hi + 3p.
// Closest records (t, prim, u, v, normal) are finished (finish_hit): decoded
// prim, triangle normals flipped toward the ray, raw barycentrics as u, v.
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "sweep.cuh"

namespace ptrt {

constexpr int kPagedThreads = 128;

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ox, const float* __restrict__ oy,
                                        const float* __restrict__ oz, const float* __restrict__ dx,
                                        const float* __restrict__ dy, const float* __restrict__ dz,
                                        int i) {
  Ray r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  return r;
}

// The lane's next pending page (lowest index first), cleared from `pend`;
// -1 when none is left.
__device__ __forceinline__ int next_page(Pend& pend) {
  if (pend.lo) {
    const int p = __ffs(pend.lo) - 1;
    pend.lo &= pend.lo - 1;
    return p;
  }
  if (pend.hi) {
    const int p = __ffs(pend.hi) - 1;
    pend.hi &= pend.hi - 1;
    return 32 + p;
  }
  return -1;
}

// _page_root_slab: does the lane enter page p's root box below `far`?
__device__ __forceinline__ bool page_root_slab(const float* __restrict__ page_lo,
                                               const float* __restrict__ page_hi, int p,
                                               const WalkRay& w, float t_min, float far) {
  const float b[6] = {page_lo[3 * p], page_lo[3 * p + 1], page_lo[3 * p + 2],
                      page_hi[3 * p], page_hi[3 * p + 1], page_hi[3 * p + 2]};
  return slab(b, w, t_min, far);
}

__device__ __forceinline__ Pend load_pend(const int* __restrict__ plo, const int* __restrict__ phi,
                                          int i) {
  // no masks: the whole tree is page 0 and every lane walks it
  Pend p;
  p.lo = plo ? (unsigned)plo[i] : 1u;
  p.hi = phi ? (unsigned)phi[i] : 0u;
  return p;
}

__device__ __forceinline__ void store_hit(const Hit& h, int i, float* __restrict__ t,
                                          int* __restrict__ prim, float* __restrict__ u,
                                          float* __restrict__ v, float* __restrict__ nx,
                                          float* __restrict__ ny, float* __restrict__ nz) {
  t[i] = h.t;
  prim[i] = h.prim;
  u[i] = h.u;
  v[i] = h.v;
  nx[i] = h.nx;
  ny[i] = h.ny;
  nz[i] = h.nz;
}

// K6a: the plane/sphere/quad sweep seeds the walk of the top tree.
__global__ void __launch_bounds__(kPagedThreads)
paged_top_closest_kernel(const float* __restrict__ top, int n_top, const float* __restrict__ tslot,
                         const float* __restrict__ ps_g, int P, int S, int Q,
                         const float* __restrict__ ox, const float* __restrict__ oy,
                         const float* __restrict__ oz, const float* __restrict__ dx,
                         const float* __restrict__ dy, const float* __restrict__ dz, int n,
                         int gid_mask, float t_min, float t_max, float* __restrict__ t_out,
                         int* __restrict__ prim_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, float* __restrict__ nx_out,
                         float* __restrict__ ny_out, float* __restrict__ nz_out,
                         int* __restrict__ plo_out, int* __restrict__ phi_out) {
  extern __shared__ float smem[];
  const SceneLayout L = scene_layout(P, S, Q, 0);
  for (int k = threadIdx.x; k < L.tb; k += blockDim.x) smem[k] = ps_g[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;  // ragged tail
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const int off = P + S + Q;
  Hit h = closest_hit(smem, L, r, t_min, t_max);
  Pend pend{0u, 0u};
  walk_closest_t<true>(top, n_top, tslot, r, t_min, off, h, &pend);
  finish_hit(h, r, off, gid_mask);
  store_hit(h, i, t_out, prim_out, u_out, v_out, nx_out, ny_out, nz_out);
  plo_out[i] = (int)pend.lo;
  phi_out[i] = (int)pend.hi;
}

// K6b: occlusion in (t_min, limit) by the planes/spheres/quads, then the top
// tree; found lanes (and lanes with limit <= 0, whose answer is not needed)
// pend no page.
__global__ void __launch_bounds__(kPagedThreads)
paged_top_any_kernel(const float* __restrict__ top, int n_top, const float* __restrict__ tslot,
                     const float* __restrict__ ps_g, int P, int S, int Q,
                     const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const float* __restrict__ limit_in, int n, float t_min,
                     uint8_t* __restrict__ found_out, int* __restrict__ plo_out,
                     int* __restrict__ phi_out) {
  extern __shared__ float smem[];
  const SceneLayout L = scene_layout(P, S, Q, 0);
  for (int k = threadIdx.x; k < L.tb; k += blockDim.x) smem[k] = ps_g[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const float limit = limit_in[i];
  Pend pend{0u, 0u};
  const bool found = limit <= 0.0f || any_hit(smem, L, r, t_min, limit) ||
                     walk_any_t<true>(top, n_top, tslot, r, t_min, limit, &pend);
  found_out[i] = found ? 1 : 0;
  plo_out[i] = (int)pend.lo;
  phi_out[i] = (int)pend.hi;
}

// K6c (K4c): the carried closest record through each pending page.
__global__ void __launch_bounds__(kPagedThreads)
pages_closest_kernel(const float* __restrict__ page_tree, long long tc,
                     const float* __restrict__ page_slot, long long sc,
                     const float* __restrict__ page_lo, const float* __restrict__ page_hi,
                     int n_pages, int gid_offset, int gid_mask, const float* __restrict__ ox,
                     const float* __restrict__ oy, const float* __restrict__ oz,
                     const float* __restrict__ dx, const float* __restrict__ dy,
                     const float* __restrict__ dz, const int* __restrict__ plo,
                     const int* __restrict__ phi, const float* __restrict__ t_in,
                     const int* __restrict__ prim_in, const float* __restrict__ u_in,
                     const float* __restrict__ v_in, const float* __restrict__ nx_in,
                     const float* __restrict__ ny_in, const float* __restrict__ nz_in, int n,
                     float t_min, float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     float* __restrict__ nx_out, float* __restrict__ ny_out,
                     float* __restrict__ nz_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const WalkRay w = walk_ray(r);
  Hit h;
  h.t = t_in[i]; h.prim = prim_in[i]; h.u = u_in[i]; h.v = v_in[i];
  h.nx = nx_in[i]; h.ny = ny_in[i]; h.nz = nz_in[i];
  const int n_page_nodes = (int)(tc / kNode4F);
  Pend pend = load_pend(plo, phi, i);
  for (int p = next_page(pend); p >= 0 && p < n_pages; p = next_page(pend)) {
    if (!page_root_slab(page_lo, page_hi, p, w, t_min, h.t)) continue;  // PAGE_CULL
    walk_closest(page_tree + (size_t)p * tc, n_page_nodes, page_slot + (size_t)p * sc, r, t_min,
                 gid_offset, h);
  }
  finish_hit(h, r, gid_offset, gid_mask);
  store_hit(h, i, t_out, prim_out, u_out, v_out, nx_out, ny_out, nz_out);
}

// K6d (K4d): the carried occlusion verdict through each pending page, up to
// the first hit.
__global__ void __launch_bounds__(kPagedThreads)
pages_any_kernel(const float* __restrict__ page_tree, long long tc,
                 const float* __restrict__ page_slot, long long sc, int n_pages,
                 const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const int* __restrict__ plo, const int* __restrict__ phi,
                 const float* __restrict__ limit_in, const uint8_t* __restrict__ found_in, int n,
                 float t_min, uint8_t* __restrict__ found_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool found = found_in[i] != 0;
  if (!found) {
    const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
    const float limit = limit_in[i];
    const int n_page_nodes = (int)(tc / kNode4F);
    Pend pend = load_pend(plo, phi, i);
    for (int p = next_page(pend); !found && p >= 0 && p < n_pages; p = next_page(pend))
      found = walk_any(page_tree + (size_t)p * tc, n_page_nodes, page_slot + (size_t)p * sc, r,
                       t_min, limit);
  }
  found_out[i] = found ? 1 : 0;
}

inline size_t ps_bytes(int P, int S, int Q) {
  return sizeof(float) * (size_t)(14 * P + 4 * S + 18 * Q);
}

inline int blocks_for(int n) { return (n + kPagedThreads - 1) / kPagedThreads; }

}  // namespace ptrt

// All four launch on `stream`, allocate nothing and do not synchronise.  Each
// returns the launch's cudaError_t (0 when the launch was accepted).  plo and
// phi may be null in the page walks: then every lane walks page 0 alone.
extern "C" int ptrt_paged_top_closest(const float* top, int n_top, const float* tslot,
                                      const float* ps, int P, int S, int Q, const float* ox,
                                      const float* oy, const float* oz, const float* dx,
                                      const float* dy, const float* dz, int n, int gid_mask,
                                      float t_min, float t_max, float* t, int* prim, float* u,
                                      float* v, float* nx, float* ny, float* nz, int* plo,
                                      int* phi, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  ptrt::paged_top_closest_kernel<<<ptrt::blocks_for(n), ptrt::kPagedThreads,
                                   ptrt::ps_bytes(P, S, Q), (cudaStream_t)stream>>>(
      top, n_top, tslot, ps, P, S, Q, ox, oy, oz, dx, dy, dz, n, gid_mask, t_min, t_max, t, prim,
      u, v, nx, ny, nz, plo, phi);
  return (int)cudaGetLastError();
}

extern "C" int ptrt_paged_top_any(const float* top, int n_top, const float* tslot, const float* ps,
                                  int P, int S, int Q, const float* ox, const float* oy,
                                  const float* oz, const float* dx, const float* dy,
                                  const float* dz, const float* limit, int n, float t_min,
                                  uint8_t* found, int* plo, int* phi, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  ptrt::paged_top_any_kernel<<<ptrt::blocks_for(n), ptrt::kPagedThreads, ptrt::ps_bytes(P, S, Q),
                               (cudaStream_t)stream>>>(top, n_top, tslot, ps, P, S, Q, ox, oy, oz,
                                                       dx, dy, dz, limit, n, t_min, found, plo,
                                                       phi);
  return (int)cudaGetLastError();
}

extern "C" int ptrt_pages_closest(const float* page_tree, long long tc, const float* page_slot,
                                  long long sc, const float* page_lo, const float* page_hi,
                                  int n_pages, int gid_offset, int gid_mask, const float* ox,
                                  const float* oy,
                                  const float* oz, const float* dx, const float* dy,
                                  const float* dz, const int* plo, const int* phi,
                                  const float* t_in, const int* prim_in, const float* u_in,
                                  const float* v_in, const float* nx_in, const float* ny_in,
                                  const float* nz_in, int n, float t_min, float* t, int* prim,
                                  float* u, float* v, float* nx, float* ny, float* nz,
                                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  ptrt::pages_closest_kernel<<<ptrt::blocks_for(n), ptrt::kPagedThreads, 0,
                               (cudaStream_t)stream>>>(
      page_tree, tc, page_slot, sc, page_lo, page_hi, n_pages, gid_offset, gid_mask, ox, oy, oz,
      dx, dy, dz, plo, phi, t_in, prim_in, u_in, v_in, nx_in, ny_in, nz_in, n, t_min, t, prim, u, v, nx, ny,
      nz);
  return (int)cudaGetLastError();
}

extern "C" int ptrt_pages_any(const float* page_tree, long long tc, const float* page_slot,
                              long long sc, int n_pages, const float* ox, const float* oy,
                              const float* oz, const float* dx, const float* dy, const float* dz,
                              const int* plo, const int* phi, const float* limit,
                              const uint8_t* found_in, int n, float t_min, uint8_t* found,
                              void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  ptrt::pages_any_kernel<<<ptrt::blocks_for(n), ptrt::kPagedThreads, 0, (cudaStream_t)stream>>>(
      page_tree, tc, page_slot, sc, n_pages, ox, oy, oz, dx, dy, dz, plo, phi, limit, found_in, n,
      t_min, found);
  return (int)cudaGetLastError();
}
