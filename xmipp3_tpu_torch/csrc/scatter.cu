// K1: three-channel shared-index scatter-add, c_k[idx[i]] += v_k[i], and
// K5: the same over ns update streams, c_k[idx[s][i]] += v[s][k][i].
//
// K1 replaces the Pallas kernel _seg_kernel of xmipp3_tpu/ops/pallas_scatter.py
// (reached through _pallas_scatter3 / scatter_add_3ch), which sorts the
// stream and accumulates one-hot MXU products tile by tile because the TPU
// has no scatter atomics. K5 replaces _seg_kernel_multi of the same file
// (reached through scatter_add_3ch_streams), which walks ns sorted streams
// per 8192-voxel tile from searchsorted tile starts. Here the adds are float
// atomics, the streams need be neither sorted nor binned, and an index
// outside [0, S) is skipped (by the function's contract it carries zeros).
// The sum order varies from run to run, which is why results are compared
// at a relative tolerance, never bit for bit.
//
// Bound on the card: by the bytes it must move (16 per update and the
// touched voxels read and written once) the function is bound by device
// memory, but what sets the time is the rate at which L2 takes atomics. A
// float atomic resolves in L2 on a 32-byte sector, which is read from
// device memory if it is not resident and written back later. Measured on
// the H100 (tools/scatter_variants.py of this package): 19.5 G adds/s with
// every lane on a sector of its own, 192 G adds/s (24 G sectors/s) with
// eight lanes a sector, which fits one L2 request per sector that a warp's
// atomic touches. So a scatter saves time by touching fewer sectors per
// warp instruction and by keeping the sectors in flight few, not by
// arithmetic. What the design does about it (each step measured on the
// card against the design without it):
//  - One accumulator at a time. The grid is (blocks, 3) with the channel in
//    blockIdx.y, so all of channel 0 goes out before channel 1 and the
//    index stream is read once per channel. Sending c0[j], c1[j], c2[j]
//    back to back from one thread, as the first design did, took 1.5 times
//    (K1) and 2.3 times (K5) as long. One launch serves the three channels.
//  - K1 sums the updates that the lanes of a warp hold for one voxel before
//    one lane adds them (xm::add_warp). On the gridding stream, which has
//    hardly a duplicate inside a warp, it costs nothing measurable; on a
//    stream with duplicates it removes the atomics' serialisation.
//  - K5 is sample-major: a thread owns column i and walks the ns streams,
//    so the taps of one sample go out together while their sectors are
//    in L2. Streams (2t, 2t+1) whose indices are x-neighbours on an 8-byte
//    boundary go out as one float2 atomic (xm::add_pair); the streams are
//    taken kChunk at a time with a chunk's loads ahead of its atomics.
//  - 16-byte loads with four updates a thread were slower than one update a
//    thread (fewer warps to hide the atomics' latency) and are not used, so
//    the operands need no alignment beyond their element size.
//
// C interface (bound with ctypes from ops/scatter.py): each function
// returns cudaGetLastError() after the launch.
#include "scatter_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;
constexpr int kChunk = 8;  // even: streams are paired inside a chunk

__global__ void scatter_add_3ch_kernel(const int32_t* __restrict__ idx,
                                       const float* __restrict__ v0,
                                       const float* __restrict__ v1,
                                       const float* __restrict__ v2,
                                       float* __restrict__ c0,
                                       float* __restrict__ c1,
                                       float* __restrict__ c2,
                                       int64_t m, int64_t s) {
  const float* __restrict__ v = xm::pick((int)blockIdx.y, v0, v1, v2);
  float* __restrict__ c = xm::pick((int)blockIdx.y, c0, c1, c2);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  // whole warps stay in the loop together: add_warp votes across the warp
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i - lane < m; i += stride) {
    const bool live = i < m;
    xm::add_warp(c, live ? idx[i] : -1, s, live ? v[i] : 0.0f);
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
  float* __restrict__ c = xm::pick((int)blockIdx.y, c0, c1, c2);
  const float* __restrict__ vc = v + (int64_t)blockIdx.y * m;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    int64_t t = 0;
    for (; t + kChunk <= ns; t += kChunk) {
      int32_t j[kChunk];
      float a[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        j[k] = idx[(t + k) * m + i];
        a[k] = vc[(t + k) * 3 * m + i];
      }
#pragma unroll
      for (int k = 0; k < kChunk; k += 2)
        xm::add_pair(c, j[k], j[k + 1], s, a[k], a[k + 1]);
    }
    for (; t + 1 < ns; t += 2)
      xm::add_pair(c, idx[t * m + i], idx[(t + 1) * m + i], s,
                   vc[t * 3 * m + i], vc[(t + 1) * 3 * m + i]);
    if (t < ns) xm::add(c, idx[t * m + i], s, vc[t * 3 * m + i]);
  }
}

dim3 grid_for(int64_t columns) {
  int64_t blocks = (columns + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return dim3((unsigned)blocks, 3);
}

}  // namespace

extern "C" int xm_scatter_add_3ch(const int32_t* idx, const float* v0,
                                  const float* v1, const float* v2, float* c0,
                                  float* c1, float* c2, int64_t m, int64_t s,
                                  void* stream) {
  scatter_add_3ch_kernel<<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      idx, v0, v1, v2, c0, c1, c2, m, s);
  return (int)cudaGetLastError();
}

extern "C" int xm_scatter_add_3ch_streams(const int32_t* idx, const float* v,
                                          float* c0, float* c1, float* c2,
                                          int64_t ns, int64_t m, int64_t s,
                                          void* stream) {
  scatter_add_3ch_streams_kernel<<<grid_for(m), kThreads, 0,
                                   (cudaStream_t)stream>>>(idx, v, c0, c1, c2,
                                                           ns, m, s);
  return (int)cudaGetLastError();
}
