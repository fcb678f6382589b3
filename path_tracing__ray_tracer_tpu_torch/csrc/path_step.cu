// One fused step of the path tracer's regeneration scheduler, one lane per
// thread, in persistent blocks:
//     glue(previous bounce record, its gathered texel)  ->  new lane state
//     bounce(the new rays)                              ->  next record
//
// Replaces the JAX package's ops/pallas/bounce_pallas.py::_path_step_kernel
// (entered there through path_step_pallas), the "pipe" mode of the
// scheduler.  The glue is the work that the default scheduler runs as torch
// ops between bounce launches: the contribution and throughput multiply-adds
// with the base colour (texel where the record is textured, else the
// material colour), retirement (miss, Russian-roulette kill, throughput
// cutoff, max depth), the park of a finished item's path sum, the item
// advance, the camera ray and counter-RNG key of a regenerated item.  Each
// term has the association of the port's torch glue (models/path_tracer.py
// `_regen_chunk`), so the mode renders the default image; built with
// --fmad=false like the plain ops it is held against.  The bounce is K1's:
// sweep.cuh's sweeps and path_shade.cuh's shading.
//
// Retired lanes (item counter == ns) trace the previous record's scatter
// ray; their contributions and parks are removed by selects, never by a
// multiply by 0.  The pixel of a lane's item is carried incrementally
// (ploc, ux, uy): the advance is a fixed stride modulo n_pix, so the
// coordinates move by two fixed deltas and one carry or borrow.
//
// What bounds it: bytes, on paper.  A lane reads 29 words (the 16-word
// record, its texel, 12 words of lane state) and writes 38 (the next
// record, the 18-word lane state with the traced rays, the 4-word park):
// 268 B a lane, 35.1 MB at N = 131,072, about 0.0105 ms at 3.35 TB/s; the
// two sweeps of K1 (22 primitives on the Cornell box) come to less.
// The design for Hopper, K1's (path_bounce.cu):
//   * each resident block copies the scene into shared memory once, the
//     primitives as primitive-major 16-byte records (sweep.cuh
//     stage_records; both sweeps by closest_hit16 / any_hit16), then the
//     material table and the light samples, where the first design's
//     ceil(N / 256) blocks each copied the field-major blob;
//   * the blocks are persistent: each warp takes its first 32 lanes by its
//     place in the grid and later ones from the stream's lane counter
//     (bvh_walk.cuh next_batch / finish_lanes);
//   * the lane state and park are written before the bounce, so they hold
//     no registers across the sweeps; the next record is written with
//     w_nee (row 2) 0 before the NEE shadow sweep, and row 2 rewritten with
//     the weight when the shadow ray comes back unoccluded, so the shading
//     state is dead during that sweep.
// Every lane's arithmetic is the first design's (git 5d3f023), expression
// for expression, so every output row is the same bits.
//
// Outputs: fout (30, N) float32 rows
//   0 hit  1 killed  2 w_nee  3 rr_scale  4 s_thr  5 t_thr  6-8 scatter origin
//   9-11 scatter direction  12-14 material colour          (the next record)
//   15-17 origin  18-20 direction (the rays this step traced)
//   21-23 throughput  24-26 running path sum                (lane state)
//   27-29 park: the finished item's path sum (0 when none)
// and iout (8, N) int32 rows
//   0 texel index of the next record (-1 untextured)  1 key  2 depth  3 item
//   counter  4 ploc  5 ux  6 uy  7 park item (ns when none)
#include <cuda_runtime.h>

#include <cstdint>

#include "bvh_walk.cuh"
#include "path_shade.cuh"
#include "sweep.cuh"

namespace ptrt {

constexpr int kStepThreads = kWalkThreads;

// The previous record and the lane state, one pointer per (N,) input.
struct StepIn {
  const int* idx;
  const int* texel;
  const float *hit, *kill, *wnee, *rrs, *sthr, *tthr;
  const float *nox, *noy, *noz, *ndx, *ndy, *ndz, *mr, *mg, *mb;
  const float *thx, *thy, *thz, *psx, *psy, *psz;
  const int *key, *depth, *s, *ploc, *ux, *uy;
};

// The scheduler's constants of one chunk.
struct StepConsts {
  int width, height, total, stride, n_pix, ns, max_depth;
  int jitter;  // 0 center, 1 diagonal (one draw for x and y), 2 independent
  int pix0, sample_base;
  uint32_t seed;
};

// The glue of lane i: its lane state and park written to rows 15-29 of fout
// and 1-7 of iout; returns the ray it traces next, with its throughput, key
// and depth for the bounce.
__device__ __forceinline__ Ray step_glue(const StepIn& in, const StepConsts& c,
                                         const float* __restrict__ cam, float* __restrict__ fout,
                                         int* __restrict__ iout, size_t N, int i, float& thx,
                                         float& thy, float& thz, uint32_t& key, int& depth2) {
  // ---- the previous record's base colour, contribution, retirement ----------
  thx = in.thx[i]; thy = in.thy[i]; thz = in.thz[i];
  float psx = in.psx[i], psy = in.psy[i], psz = in.psz[i];
  key = (uint32_t)in.key[i];
  const int depth = in.depth[i];
  const int s = in.s[i];
  int ploc = in.ploc[i], ux = in.ux[i], uy = in.uy[i];

  const int texel = in.texel[i];
  const bool textured = in.idx[i] >= 0;
  const bool hitb = in.hit[i] > 0.5f;
  const bool notkill = in.kill[i] <= 0.5f;
  const float wnee = in.wnee[i], rrs = in.rrs[i], sthr = in.sthr[i], tthr = in.tthr[i];
  const float wsky = hitb ? 0.0f : kSky;
  const float inv255 = (float)(1.0 / 255.0);
  const float br = textured ? (float)(texel & 0xFF) * inv255 : in.mr[i];
  const float bg = textured ? (float)((texel >> 8) & 0xFF) * inv255 : in.mg[i];
  const float bb = textured ? (float)((texel >> 16) & 0xFF) * inv255 : in.mb[i];

  const bool active = s < c.ns;
  psx = psx + (active ? thx * wsky + thx * (br * wnee) : 0.0f);
  psy = psy + (active ? thy * wsky + thy * (bg * wnee) : 0.0f);
  psz = psz + (active ? thz * wsky + thz * (bb * wnee) : 0.0f);

  bool live = active && hitb && notkill;
  if (live) {
    thx = thx * rrs * (br * tthr + sthr);
    thy = thy * rrs * (bg * tthr + sthr);
    thz = thz * rrs * (bb * tthr + sthr);
  }
  // the throughput cutoff on the largest channel (a NaN fails it, as in torch)
  const float maxc = fmaxf(thx, fmaxf(thy, thz));
  const bool nan = thx != thx || thy != thy || thz != thz;
  live = live && !nan && maxc >= 0.001f;
  const int ndepth = depth + 1;
  live = live && ndepth < c.max_depth;
  const bool done = active && !live;

  // ---- item advance: ploc += stride (mod n_pix), the pixel by fixed deltas --
  const int s2 = s + (done ? 1 : 0);
  if (done) {
    const int back = c.n_pix - c.stride;  // the wrapping step is -back
    int pl2 = ploc + c.stride;
    const bool wrap = pl2 >= c.n_pix;
    if (wrap) pl2 -= c.n_pix;
    int ax = wrap ? ux - back % c.width : ux + c.stride % c.width;
    int ay = wrap ? uy - back / c.width : uy + c.stride / c.width;
    ay = ax >= c.width ? ay + 1 : (ax < 0 ? ay - 1 : ay);
    ax = ax >= c.width ? ax - c.width : (ax < 0 ? ax + c.width : ax);
    ploc = pl2;
    ux = ax;
    uy = ay;
  }

  // ---- the camera ray and key of the (possibly) regenerated item ------------
  // the key hashes the unclamped pixel index, the jitter coordinates clamp
  // to the last pixel (the scheduler's make_ray)
  const int idxg = c.pix0 + ploc;
  const uint32_t k1 = fmix32(((uint32_t)idxg ^ (c.seed * kGammaDepth)) + kInc);
  const uint32_t keyn = fmix32((k1 + (uint32_t)(c.sample_base + s2) * kGammaUse) + kInc);
  float r1 = 0.5f, r2 = 0.5f;
  if (c.jitter != 0) {
    r1 = uniform01(keyn, (uint32_t)c.max_depth, 0u);
    r2 = c.jitter == 1 ? r1 : uniform01(keyn, (uint32_t)c.max_depth, 1u);
  }
  const bool over = idxg > c.total - 1;
  const float xs = over ? (float)((c.total - 1) % c.width) : (float)ux;
  const float ys = over ? (float)((c.total - 1) / c.width) : (float)uy;
  const float su = (xs + r1) / (float)c.width;
  const float sv = (ys + r2) / (float)c.height;
  const float gdx = cam[3] + cam[6] * su + cam[9] * sv - cam[0];
  const float gdy = cam[4] + cam[7] * su + cam[10] * sv - cam[1];
  const float gdz = cam[5] + cam[8] * su + cam[11] * sv - cam[2];
  const float nn = sqrtf(gdx * gdx + gdy * gdy + gdz * gdz);
  const bool pos = nn > 0.0f;
  const float invn = 1.0f / (pos ? nn : 1.0f);

  const bool regen = done && s2 < c.ns;
  Ray r;
  r.ox = regen ? cam[0] : in.nox[i];
  r.oy = regen ? cam[1] : in.noy[i];
  r.oz = regen ? cam[2] : in.noz[i];
  r.dx = regen ? (pos ? gdx * invn : 0.0f) : in.ndx[i];
  r.dy = regen ? (pos ? gdy * invn : 0.0f) : in.ndy[i];
  r.dz = regen ? (pos ? gdz * invn : 0.0f) : in.ndz[i];
  if (regen) {
    thx = 1.0f; thy = 1.0f; thz = 1.0f;
    key = keyn;
  }
  depth2 = live ? ndepth : 0;

  // ---- lane state and park ----------------------------------------------------
  fout[15 * N + i] = r.ox; fout[16 * N + i] = r.oy; fout[17 * N + i] = r.oz;
  fout[18 * N + i] = r.dx; fout[19 * N + i] = r.dy; fout[20 * N + i] = r.dz;
  fout[21 * N + i] = thx; fout[22 * N + i] = thy; fout[23 * N + i] = thz;
  fout[24 * N + i] = done ? 0.0f : psx;
  fout[25 * N + i] = done ? 0.0f : psy;
  fout[26 * N + i] = done ? 0.0f : psz;
  fout[27 * N + i] = done ? psx : 0.0f;
  fout[28 * N + i] = done ? psy : 0.0f;
  fout[29 * N + i] = done ? psz : 0.0f;
  iout[1 * N + i] = (int)key;
  iout[2 * N + i] = depth2;
  iout[3 * N + i] = s2;
  iout[4 * N + i] = ploc;
  iout[5 * N + i] = ux;
  iout[6 * N + i] = uy;
  iout[7 * N + i] = done ? s : c.ns;
  return r;
}

// `counter`: two int32, zero at the launch and left zero (finish_lanes).
__global__ void __launch_bounds__(kStepThreads)
path_step_persistent(const float* __restrict__ blob_g, int P, int S, int Q, int T,
                     const float* __restrict__ mat_g, int n_mats,
                     const float* __restrict__ light_g, int n_lights,
                     const int* __restrict__ tex_tbl, int n_tex, const float* __restrict__ cam,
                     StepIn in, StepConsts c, float* __restrict__ fout, int* __restrict__ iout,
                     int n, float t_min, float t_max, int shadow_light,
                     int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  const SceneLayout L = scene_layout(P, S, Q, T);
  const RecLayout R = rec_layout(P, S, Q, T);
  float* smem = reinterpret_cast<float*>(smem4);
  stage_records(smem, blob_g, L, R);
  float* mat = smem + mat_offset(R);
  float* light = smem + light_offset(R, kMatFields * n_mats);  // field-major, as nee_query reads
  for (int k = threadIdx.x; k < kMatFields * n_mats; k += blockDim.x) mat[k] = mat_g[k];
  for (int k = threadIdx.x; k < 3 * n_lights; k += blockDim.x) light[k] = light_g[k];
  __syncthreads();
  const float4* rec = smem4;
  const size_t N = (size_t)n;

  const int lane = threadIdx.x & 31;
  const int span = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;; i = next_batch(counter, span, n)) {
    if (i - lane >= n) break;  // the warp's batch is past the end
    if (i >= n) continue;
    float thx, thy, thz;
    uint32_t key;
    int depth2;
    const Ray r = step_glue(in, c, cam, fout, iout, N, i, thx, thy, thz, key, depth2);

    // ---- bounce the new rays (K1) ---------------------------------------------
    const Hit h = closest_hit16(rec, R, r, t_min, t_max);
    const Surface sf{h.prim >= 0, r.ox + r.dx * h.t, r.oy + r.dy * h.t, r.oz + r.dz * h.t,
                     h.nx, h.ny, h.nz, h.u, h.v};
    const Material m = sf.hit ? material_row(mat, n_mats, h.prim) : miss_material();
    const ShadowQuery q = nee_query(light, n_lights, key, (uint32_t)depth2, sf, m, t_max,
                                    shadow_light);
    const Scatter sc = scatter(key, (uint32_t)depth2, r, thx, thy, thz, sf, m);

    // the texel index of the hit (ops/texture._nearest_index), -1 untextured
    const float tex = record_tex(m);
    int idx = -1;
    if (n_tex > 0 && tex >= 0.0f) {
      const int tid = min(max((int)tex, 0), n_tex - 1);
      const int w = tex_tbl[tid], ht = tex_tbl[n_tex + tid], off = tex_tbl[2 * n_tex + tid];
      const float uu = fminf(fmaxf(sf.u, 0.0f), 1.0f);
      const float vv = fminf(fmaxf(sf.v, 0.0f), 1.0f);
      const int iu = min(max((int)(uu * (float)(w - 1)), 0), w - 1);
      const int iv = min(max((int)((1.0f - vv) * (float)(ht - 1)), 0), ht - 1);
      idx = off + iv * w + iu;
    }

    // ---- the next record with w_nee 0, then its weight when the shadow ray
    // comes back unoccluded (the first occluder ends its sweep) --------------
    iout[i] = idx;
    fout[0 * N + i] = sf.hit ? 1.0f : 0.0f;
    fout[1 * N + i] = sc.killed ? 1.0f : 0.0f;
    fout[2 * N + i] = 0.0f;
    fout[3 * N + i] = sc.rr_scale;
    fout[4 * N + i] = sc.s_thr;
    fout[5 * N + i] = sc.t_thr;
    fout[6 * N + i] = sc.nox; fout[7 * N + i] = sc.noy; fout[8 * N + i] = sc.noz;
    fout[9 * N + i] = sc.ndx; fout[10 * N + i] = sc.ndy; fout[11 * N + i] = sc.ndz;
    fout[12 * N + i] = m.r; fout[13 * N + i] = m.g; fout[14 * N + i] = m.b;
    if (q.care && !any_hit16(rec, R, q.ray, t_min, q.bound)) fout[2 * N + i] = q.w;
  }
  if (span < n) finish_lanes(counter);
}

}  // namespace ptrt

// Resident blocks per SM with `smem` bytes of dynamic shared memory, into
// *blocks; first lifts the kernel's dynamic shared memory limit to `smem`
// where it is lower.
extern "C" int ptrt_path_step_occupancy(int smem, int* blocks) {
  cudaError_t err = ptrt::allow_smem(ptrt::path_step_persistent, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ptrt::path_step_persistent,
                                                        ptrt::kStepThreads, smem);
  return (int)err;
}

// `grid` persistent blocks with `smem` bytes of dynamic shared memory (the
// records, materials and lights of K1's tables; ops/cuda/bounce.sweep_plan),
// which ptrt_path_step_occupancy has allowed; `counter` is two int32 of
// scratch, zero at the launch and left zero by the kernel.  Launches on
// `stream`; allocates nothing and does not synchronise.  Returns the
// launch's cudaError_t (0 when the launch was accepted).  `n_tex` is 0 when
// the scene has no textured primitive (every record untextured).
extern "C" int ptrt_path_step(const float* blob, int P, int S, int Q, int T, const float* mat,
                              int n_mats, const float* lights, int n_lights, const int* tex_tbl,
                              int n_tex, const float* cam, ptrt::StepIn in, ptrt::StepConsts c,
                              float* fout, int* iout, int n, float t_min, float t_max,
                              int shadow_light, int* counter, int smem, int grid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if ((size_t)smem < ptrt::bounce_smem_bytes(P, S, Q, T, n_mats, n_lights))
    return (int)cudaErrorInvalidValue;
  ptrt::path_step_persistent<<<grid, ptrt::kStepThreads, smem, (cudaStream_t)stream>>>(
      blob, P, S, Q, T, mat, n_mats, lights, n_lights, tex_tbl, n_tex, cam, in, c, fout, iout, n,
      t_min, t_max, shadow_light, counter);
  return (int)cudaGetLastError();
}
