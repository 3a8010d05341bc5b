// K1: three-channel shared-index scatter-add, c_k[idx[i]] += v_k[i], and
// K5: the same over ns update streams, c_k[idx[s][i]] += v[s][k][i].
//
// Replaces the Pallas kernel _seg_kernel of xmipp3_tpu/ops/pallas_scatter.py
// (reached through _pallas_scatter3 / scatter_add_3ch). That kernel sorts the
// stream and accumulates one-hot MXU products tile by tile, because the TPU
// has no scatter atomics. Here each thread takes updates from a grid-stride
// loop and adds them with three float atomics: the sum order then varies
// from run to run, which is why results are compared at a relative
// tolerance, never bit for bit.
//
// Bound on the card: the atomics, which resolve in L2. The bytes the
// function must move are 16 per update plus the three accumulator cubes
// read and written once; the update throughput of float atomics to L2, and
// their contention where neighbouring samples hit one voxel, is what sets
// the time in practice.
//
// K5 replaces _seg_kernel_multi of the same file (reached through
// scatter_add_3ch_streams), which walks ns sorted streams per 8192-voxel
// tile, found by a searchsorted over each stream. With atomics the streams
// need be neither sorted nor binned: one grid-stride loop runs over all
// ns * M updates and shares K1's device code. An index outside [0, S) is
// skipped; by the function's contract it carries zero values.
//
// C interface (bound with ctypes from ops/scatter.py): each function
// returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;

__device__ __forceinline__ void add3(float* __restrict__ c0,
                                     float* __restrict__ c1,
                                     float* __restrict__ c2, int32_t j,
                                     int64_t s, float a0, float a1, float a2) {
  if (j < 0 || j >= s) return;  // out-of-range updates are dropped
  atomicAdd(c0 + j, a0);
  atomicAdd(c1 + j, a1);
  atomicAdd(c2 + j, a2);
}

__global__ void scatter_add_3ch_kernel(const int32_t* __restrict__ idx,
                                       const float* __restrict__ v0,
                                       const float* __restrict__ v1,
                                       const float* __restrict__ v2,
                                       float* __restrict__ c0,
                                       float* __restrict__ c1,
                                       float* __restrict__ c2,
                                       int64_t m, int64_t s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    add3(c0, c1, c2, idx[i], s, v0[i], v1[i], v2[i]);
  }
}

// idx (ns, m), v (ns, 3, m): update i of stream t reads idx[t][i] and
// v[t][0..2][i].
__global__ void scatter_add_3ch_streams_kernel(const int32_t* __restrict__ idx,
                                               const float* __restrict__ v,
                                               float* __restrict__ c0,
                                               float* __restrict__ c1,
                                               float* __restrict__ c2,
                                               int64_t ns, int64_t m,
                                               int64_t s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; u < ns * m;
       u += stride) {
    const int64_t t = u / m, i = u - t * m;
    const float* vt = v + t * 3 * m + i;
    add3(c0, c1, c2, idx[u], s, vt[0], vt[m], vt[2 * m]);
  }
}

}  // namespace

extern "C" int xm_scatter_add_3ch(const int32_t* idx, const float* v0,
                                  const float* v1, const float* v2, float* c0,
                                  float* c1, float* c2, int64_t m, int64_t s,
                                  void* stream) {
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  scatter_add_3ch_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(idx, v0, v1, v2, c0, c1, c2,
                                                   m, s);
  return (int)cudaGetLastError();
}

extern "C" int xm_scatter_add_3ch_streams(const int32_t* idx, const float* v,
                                          float* c0, float* c1, float* c2,
                                          int64_t ns, int64_t m, int64_t s,
                                          void* stream) {
  int64_t blocks = (ns * m + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  scatter_add_3ch_streams_kernel<<<(unsigned)blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(idx, v, c0, c1, c2,
                                                           ns, m, s);
  return (int)cudaGetLastError();
}
