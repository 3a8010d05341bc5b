// Three experiments beside the shared-index scatter kernels K1
// (scatter_add_3ch) and K5 (scatter_add_3ch_streams) of csrc/scatter.cu, for
// scatter_variants.py beside this file, which holds each against index_add_
// and times it beside the package's kernels on one card. They isolate the
// steps of csrc/scatter_common.cuh that the gridding kernels can take over
// one by one:
//   xv_k1_channel   K1 with the channel in blockIdx.y and plain atomics:
//                   the package's K1 without add_warp
//   xv_k5_channel   K5 sample-major with the channel in blockIdx.y and
//                   scalar atomics: the package's K5 without add_pair
//   xv_k1_cube4     K1's stream into one interleaved (S, 4) accumulator, one
//                   float4 atomic per update (another contract than the
//                   three planar accumulators: what a layout change buys)
#include "scatter_common.cuh"

using namespace xm;

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;

unsigned blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  return (unsigned)(b > kMaxBlocks ? kMaxBlocks : (b < 1 ? 1 : b));
}

__global__ void k1_channel(const int32_t* __restrict__ idx,
                           const float* __restrict__ v0,
                           const float* __restrict__ v1,
                           const float* __restrict__ v2,
                           float* __restrict__ c0, float* __restrict__ c1,
                           float* __restrict__ c2, int64_t m, int64_t s) {
  const float* __restrict__ v = pick((int)blockIdx.y, v0, v1, v2);
  float* __restrict__ c = pick((int)blockIdx.y, c0, c1, c2);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride)
    add(c, idx[i], s, v[i]);
}

// idx (ns, m), v (ns, 3, m)
__global__ void k5_channel(const int32_t* __restrict__ idx,
                           const float* __restrict__ v,
                           float* __restrict__ c0, float* __restrict__ c1,
                           float* __restrict__ c2, int64_t ns, int64_t m,
                           int64_t s) {
  float* __restrict__ c = pick((int)blockIdx.y, c0, c1, c2);
  const float* __restrict__ vc = v + (int64_t)blockIdx.y * m;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride)
    for (int64_t t = 0; t < ns; ++t)
      add(c, idx[t * m + i], s, vc[t * 3 * m + i]);
}

__global__ void k1_cube4(const int32_t* __restrict__ idx,
                         const float* __restrict__ v0,
                         const float* __restrict__ v1,
                         const float* __restrict__ v2,
                         float4* __restrict__ acc, int64_t m, int64_t s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const int32_t j = idx[i];
    if (in_range(j, s))
      atomicAdd(acc + j, make_float4(v0[i], v1[i], v2[i], 0.0f));
  }
}

}  // namespace

extern "C" int xv_k1_channel(const int32_t* idx, const float* v0,
                             const float* v1, const float* v2, float* c0,
                             float* c1, float* c2, int64_t m, int64_t s,
                             void* stream) {
  k1_channel<<<dim3(blocks_for(m), 3), kThreads, 0, (cudaStream_t)stream>>>(
      idx, v0, v1, v2, c0, c1, c2, m, s);
  return (int)cudaGetLastError();
}

extern "C" int xv_k5_channel(const int32_t* idx, const float* v, float* c0,
                             float* c1, float* c2, int64_t ns, int64_t m,
                             int64_t s, void* stream) {
  k5_channel<<<dim3(blocks_for(m), 3), kThreads, 0, (cudaStream_t)stream>>>(
      idx, v, c0, c1, c2, ns, m, s);
  return (int)cudaGetLastError();
}

extern "C" int xv_k1_cube4(const int32_t* idx, const float* v0,
                           const float* v1, const float* v2, float* acc4,
                           int64_t m, int64_t s, void* stream) {
  k1_cube4<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      idx, v0, v1, v2, reinterpret_cast<float4*>(acc4), m, s);
  return (int)cudaGetLastError();
}
