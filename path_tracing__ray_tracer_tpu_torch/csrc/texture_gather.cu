// RGB in [0, 1] of flat texel indices into a packed-int32 atlas, one lane
// per thread: the atlas gather (K8) and the mip gather (K9).
//
// Replace the JAX package's ops/pallas/texture_pallas.py::_gather_kernel
// (entered there through mxu_gather_rgb, the gated atlas route of the path
// tracer's resolve) and ::_mip_kernel (entered through mip_gather_rgb, the
// deferred-texture and texture-LOD modes).  On the TPU both are one-hot
// bf16 matmuls against three (R, 128) channel planes, exact because the
// channels are 0-255 integers.  Hopper gathers per lane, so each thread
// reads its one packed texel and unpacks its three bytes; no tensor core,
// no bf16.  Semantics kept: the index is clamped to [0, 128·R - 1] with
// R = ceil(n_texels / 128), and an index past the atlas (the zero padding
// of the TPU planes) reads texel 0x000000.  The scale is float32(1/255)
// after the byte, as the plain version (`_unpack_rgb`) multiplies.
//
// What bounds them: bytes.  A lane reads its index (4 B) and its texel
// (4 B) and writes three floats (12 B): 20 B a lane, 2.6 MB at
// N = 131,072, about 0.00078 ms at 3.35 TB/s.  The texel read is the only
// random access; neighbouring lanes' index and output streams coalesce.
//
// Output: (3, N) float32, rows r, g, b.
#include <cuda_runtime.h>

#include <cstdint>

namespace ptrt {

constexpr int kGatherThreads = 256;

__global__ void __launch_bounds__(kGatherThreads)
gather_rgb_kernel(const int* __restrict__ table, int n_texels, const int* __restrict__ idx_in,
                  float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int last = ((n_texels + 127) / 128) * 128 - 1;
  const int k = min(max(idx_in[i], 0), last);
  const int t = k < n_texels ? __ldg(table + k) : 0;
  const float inv255 = (float)(1.0 / 255.0);
  const size_t N = (size_t)n;
  out[i] = (float)(t & 0xFF) * inv255;
  out[N + i] = (float)((t >> 8) & 0xFF) * inv255;
  out[2 * N + i] = (float)((t >> 16) & 0xFF) * inv255;
}

int launch_gather(const int* table, int n_texels, const int* idx, float* out, int n,
                  void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + kGatherThreads - 1) / kGatherThreads;
  gather_rgb_kernel<<<blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(table, n_texels, idx,
                                                                          out, n);
  return (int)cudaGetLastError();
}

}  // namespace ptrt

// Launch on `stream`; allocate nothing and do not synchronise.  Return the
// launch's cudaError_t (0 when the launch was accepted).  One kernel under
// the two names that the kernel table counts apart: K8 on the atlas, K9 on
// the mip.
extern "C" int ptrt_atlas_gather(const int* atlas, int n_texels, const int* idx, float* out,
                                 int n, void* stream) {
  return ptrt::launch_gather(atlas, n_texels, idx, out, n, stream);
}

extern "C" int ptrt_mip_gather(const int* mip, int n_texels, const int* idx, float* out, int n,
                               void* stream) {
  return ptrt::launch_gather(mip, n_texels, idx, out, n, stream);
}
