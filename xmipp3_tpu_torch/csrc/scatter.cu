// K1: three-channel shared-index scatter-add, c_k[idx[i]] += v_k[i].
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
// C interface (bound with ctypes from ops/scatter.py): returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
    const int32_t j = idx[i];
    if (j < 0 || j >= s) continue;  // out-of-range updates are dropped
    atomicAdd(c0 + j, v0[i]);
    atomicAdd(c1 + j, v1[i]);
    atomicAdd(c2 + j, v2[i]);
  }
}

}  // namespace

extern "C" int xm_scatter_add_3ch(const int32_t* idx, const float* v0,
                                  const float* v1, const float* v2, float* c0,
                                  float* c1, float* c2, int64_t m, int64_t s,
                                  void* stream) {
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  scatter_add_3ch_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(idx, v0, v1, v2, c0, c1, c2,
                                                   m, s);
  return (int)cudaGetLastError();
}
