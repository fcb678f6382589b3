// One whole path-tracer bounce on a BVH scene, one ray per thread (K5).
//
// Replaces the JAX package's ops/pallas/bounce_bvh_pallas.py::
// _path_bounce_bvh_kernel (entered there through path_bounce_bvh_pallas)
// in its shipped split form (BVH_BOUNCE_SPLIT_ANY): the closest hit (the
// plane/sphere/quad sweep seeding the BVH4 walk of bvh_walk.cuh), the
// winner's material from the unique-material table, NEE preparation, Russian
// roulette and the scatter of path_shade.cuh.  The shadow query is not
// answered here: each lane emits its shadow ray, which K4b
// (bvh_scene.cu's bvh_any_persistent) answers in a second launch; the
// caller zeroes w_nee where it is occluded.
//
// The material needs no per-primitive table: a triangle winner's slot gid
// carries its unique-material id (uid << 17 | tri), and the few
// non-triangle primitives map to theirs through `psuid`.  Triangle UVs are
// 0: the caller takes this kernel only when no textured triangle reads them.
//
// What bounds it: latency, as K4a (one walk per ray, a chain of dependent
// loads); the shading adds about 60 float operations.  Per ray it reads
// 44 B and writes 76 B of record, 4 B of prim and 28 B of shadow ray.
//
// The kernel is designed for Hopper (path_bounce_bvh_persistent), as K4b
// is: persistent blocks of 256 threads, as many as are resident, whose warps
// take 32 lanes at a time from a counter; the BVH4 node table read from
// device memory, or copied into each block's shared memory by one bulk copy
// (TMA) when it fits the budget of ops/cuda/bvh.py, as eight 16-byte loads a
// node either way; the padded 64 B slot records read as 16-byte loads; a
// stack in local memory sized by the tree's depth class.
// The lane body (bounce_lane) is the first design's, so each lane's
// arithmetic and record are too (the first design, one lane per thread in
// blocks of 128, is in git at edf8737).
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

// The lane inputs and outputs of one bounce.
struct BounceIO {
  const int* __restrict__ depth;
  const float *__restrict__ ox, *__restrict__ oy, *__restrict__ oz;
  const float *__restrict__ dx, *__restrict__ dy, *__restrict__ dz;
  const float *__restrict__ tx, *__restrict__ ty, *__restrict__ tz;
  const int* __restrict__ key;
  float* __restrict__ out;
  int* __restrict__ prim;
  float* __restrict__ shadow;
  int n;
  float t_min, t_max;
  int shadow_light;
};

// The scene tables the kernel stages in shared memory, in this order.
struct BounceTables {
  const float* __restrict__ ps;
  int P, S, Q;
  const float* __restrict__ psuid;
  const float* __restrict__ umat;
  int n_umats;
  const float* __restrict__ light;
  int n_lights;

  __host__ __device__ int floats() const {
    return 14 * P + 4 * S + 18 * Q + (P + S + Q) + kMatFields * n_umats + 3 * n_lights;
  }
};

__device__ __forceinline__ void stage_tables(float* smem, const BounceTables& t,
                                             const SceneLayout& L) {
  const int off = t.P + t.S + t.Q;
  const int umat_size = kMatFields * t.n_umats;
  const int total = L.tb + off + umat_size + 3 * t.n_lights;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    smem[k] = k < L.tb ? t.ps[k]
              : k < L.tb + off ? t.psuid[k - L.tb]
              : k < L.tb + off + umat_size ? t.umat[k - L.tb - off]
                                           : t.light[k - L.tb - off - umat_size];
  }
}

// Lane i's bounce over the tables staged at `ps`; walk(r, h) is the BVH4
// closest-hit walk seeded with the plane/sphere/quad winner h.
template <class Walk>
__device__ __forceinline__ void bounce_lane(int i, const float* ps, const SceneLayout& L,
                                            const BounceTables& t, const BounceIO& io,
                                            const Walk& walk) {
  const int off = t.P + t.S + t.Q;
  const float* psuid = ps + L.tb;
  const float* umat = psuid + off;
  const float* light = umat + kMatFields * t.n_umats;

  const uint32_t depth = (uint32_t)io.depth[i];
  const uint32_t key = (uint32_t)io.key[i];
  Ray r;
  r.ox = io.ox[i]; r.oy = io.oy[i]; r.oz = io.oz[i];
  r.dx = io.dx[i]; r.dy = io.dy[i]; r.dz = io.dz[i];

  // ---- closest hit: the plane/sphere/quad sweep seeds the BVH4 walk -------
  Hit h = closest_hit(ps, L, r, io.t_min, io.t_max);
  walk(r, h);
  const bool is_tri = h.prim >= off;
  int uid = h.prim >= 0 ? (int)psuid[h.prim < off ? h.prim : 0] : -1;
  if (is_tri) {
    uid = (h.prim - off) >> kGidUidBits;
    const float sgn = h.nx * r.dx + h.ny * r.dy + h.nz * r.dz > 0.0f ? -1.0f : 1.0f;
    h.nx = h.nx * sgn; h.ny = h.ny * sgn; h.nz = h.nz * sgn;
  }
  const Surface s{h.prim >= 0, r.ox + r.dx * h.t, r.oy + r.dy * h.t, r.oz + r.dz * h.t,
                  h.nx, h.ny, h.nz, is_tri ? 0.0f : h.u, is_tri ? 0.0f : h.v};
  const Material m = uid >= 0 ? material_row(umat, t.n_umats, uid) : miss_material();

  // ---- NEE: the shadow ray goes out for K4b; w_nee is masked afterwards ----
  const ShadowQuery q = nee_query(light, t.n_lights, key, depth, s, m, io.t_max, io.shadow_light);
  float* so = io.shadow + i;
  const size_t N = (size_t)io.n;
  so[0 * N] = q.ray.ox;
  so[1 * N] = q.ray.oy;
  so[2 * N] = q.ray.oz;
  so[3 * N] = q.ray.dx;
  so[4 * N] = q.ray.dy;
  so[5 * N] = q.ray.dz;
  so[6 * N] = q.care ? q.bound : -1.0f;

  scatter_write(io.out, io.n, i, key, depth, r, io.tx[i], io.ty[i], io.tz[i], s, m,
                q.care ? q.w : 0.0f);
  io.prim[i] = decode_prim(h.prim, off);
}

// K5 for Hopper: lanes [0, n) taken 32 at a time from `counter` (two
// int32, zero at the launch, left zero; finish_lanes).
template <bool kStage, int kDepth>
__global__ void __launch_bounds__(kWalkThreads, 2)
path_bounce_bvh_persistent(const float* __restrict__ nodes, int n_nodes,
                           const float* __restrict__ slot16, const BounceTables t,
                           const BounceIO io, int* __restrict__ counter) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bar;
  const SceneLayout L = scene_layout(t.P, t.S, t.Q, 0);
  float* tree = reinterpret_cast<float*>(smem4);
  float* tables = tree + tree_smem_bytes(kStage, n_nodes) / sizeof(float);
  if (kStage && threadIdx.x == 0)
    bulk_copy_start(tree, nodes, (uint32_t)tree_smem_bytes(kStage, n_nodes), &bar);
  stage_tables(tables, t, L);
  __syncthreads();
  if (kStage) bulk_copy_wait(&bar);
  const Vec4Nodes<kStage> src{reinterpret_cast<const float4*>(kStage ? tree : nodes)};
  const Slot16Leaf leaf{reinterpret_cast<const float4*>(slot16)};
  const int off = t.P + t.S + t.Q;
  for (;;) {
    const int i = next_lane(counter);
    if (i - (int)(threadIdx.x & 31) >= io.n) break;  // the warp's batch is past the end
    if (i >= io.n) continue;
    bounce_lane(i, tables, L, t, io, [&](const Ray& r, Hit& h) {
      LocalStack<stack_cap(kDepth)> stack;
      walk_closest_with<false>(src, n_nodes, leaf, stack, r, io.t_min, off, h, nullptr);
    });
  }
  finish_lanes(counter);
}

using BounceKernel = decltype(&path_bounce_bvh_persistent<false, kMaxDepth4>);

// The variants the wrapper picks among (ops/cuda/bvh.walk_plan), as K4b's.
inline BounceKernel bounce_variant(int stage, int depth_class) {
  if (depth_class == kShallow4)
    return stage ? path_bounce_bvh_persistent<true, kShallow4>
                 : path_bounce_bvh_persistent<false, kShallow4>;
  if (depth_class == kMaxDepth4)
    return stage ? path_bounce_bvh_persistent<true, kMaxDepth4>
                 : path_bounce_bvh_persistent<false, kMaxDepth4>;
  return nullptr;
}

}  // namespace ptrt

namespace {

ptrt::BounceTables tables_of(const float* ps, int P, int S, int Q, const float* psuid,
                             const float* umat, int n_umats, const float* lights, int n_lights) {
  return ptrt::BounceTables{ps, P, S, Q, psuid, umat, n_umats, lights, n_lights};
}

ptrt::BounceIO io_of(const int* depth, const float* ox, const float* oy, const float* oz,
                     const float* dx, const float* dy, const float* dz, const float* tx,
                     const float* ty, const float* tz, const int* key, float* out, int* prim,
                     float* shadow, int n, float t_min, float t_max, int shadow_light) {
  return ptrt::BounceIO{depth, ox, oy, oz, dx, dy, dz, tx, ty, tz, key, out, prim, shadow,
                        n, t_min, t_max, shadow_light};
}

}  // namespace

// Resident blocks per SM of the K5 variant (stage, depth_class) with `smem`
// bytes of dynamic shared memory, into *blocks; first lifts the variant's
// dynamic shared memory limit to `smem` where it is lower.
extern "C" int ptrt_path_bounce_bvh_occupancy(int stage, int depth_class, int smem, int* blocks) {
  const ptrt::BounceKernel k = ptrt::bounce_variant(stage, depth_class);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = ptrt::allow_smem(k, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, ptrt::kWalkThreads, smem);
  return (int)err;
}

// K5 launches on `stream`, allocates nothing and does not synchronise; it
// returns the launch's cudaError_t (0 when the launch was accepted).
// `grid` persistent blocks of the variant (stage, depth_class) with
// `smem` bytes of dynamic shared memory (the tree and the tables), which
// ptrt_path_bounce_bvh_occupancy has allowed; `counter` is two int32 of
// scratch, zero at the launch and left zero by the kernel.  `slot16`: the
// padded slot records.
extern "C" int ptrt_path_bounce_bvh(
    const float* nodes, int n_nodes, const float* slot16, const float* ps, int P, int S, int Q,
    const float* psuid, const float* umat, int n_umats, const float* lights, int n_lights,
    const int* depth, const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tx, const float* ty, const float* tz,
    const int* key, float* out, int* prim, float* shadow, int n, float t_min, float t_max,
    int shadow_light, int* counter, int stage, int depth_class, int smem, int grid,
    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const ptrt::BounceKernel k = ptrt::bounce_variant(stage, depth_class);
  const ptrt::BounceTables t = tables_of(ps, P, S, Q, psuid, umat, n_umats, lights, n_lights);
  if (k == nullptr ||
      (size_t)smem < ptrt::tree_smem_bytes(stage, n_nodes) + sizeof(float) * t.floats())
    return (int)cudaErrorInvalidValue;
  k<<<grid, ptrt::kWalkThreads, smem, (cudaStream_t)stream>>>(
      nodes, n_nodes, slot16, t,
      io_of(depth, ox, oy, oz, dx, dy, dz, tx, ty, tz, key, out, prim, shadow, n, t_min, t_max,
            shadow_light),
      counter);
  return (int)cudaGetLastError();
}
