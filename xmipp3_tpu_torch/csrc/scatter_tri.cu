// K2: trilinear gridding of raw Fourier samples into three (P, P, P) cubes.
//
// Replaces the Pallas kernel _tri_kernel of xmipp3_tpu/ops/pallas_scatter_tri.py
// (reached through tri_scatter_packed). That kernel sorts the raw samples,
// expands the four in-plane taps after the sort, streams each tile's rows
// once and carries the dz = 1 taps in a lag ring, all in a packed
// (ntiles, 128, 96) layout built for the TPU's one-hot MXU products. None of
// that carries over: here one thread takes one sample, computes its floor
// corner and fractions, and adds its 8 corner taps. A corner outside [0, P)
// on any axis is skipped, the per-axis mask of
// xmipp3_tpu/ops/reconstruct.py:254-256 (the XLA path the tests hold this
// kernel against); the TPU kernel masked x+1 and y+1 through its flat base
// and let z+1 spill into padding, which differs only at the |k| = Nyquist
// edge.
//
// Bound on the card: neither the bytes (24 read per sample, the touched
// voxels of the three cubes read and written once) nor the arithmetic. The
// float atomics are, resolved in L2 at one request per 32-byte sector a
// warp's instruction touches. The first design sent 24 scalar atomics a
// sample, the three cubes interleaved: 1.38 ms for one 256-image batch at
// N=128, P=256 (M = 1,661,440 samples, 13.3 M live taps), 19 times its
// sector bound, on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
// The kernel that replaces it (measured with tools/tri_variants.py on the
// same card and batch): the channel is blockIdx.y (xm::pick), which the
// card schedules after all of blockIdx.x, so one 64 MiB cube is walked at a
// time (0.646 ms with scalar atomics); a (dz, dy) row's two taps x0, x0 + 1
// go out together through xm::add_row2, as the float4 atomic of the 16-byte
// quad that holds both, zeros in its other lanes, or as two scalar adds
// where the pair straddles two quads: 0.494 ms. (One float2 where the pair
// starts on an 8-byte boundary and two scalars elsewhere took 0.544; one
// interleaved (P, P, P, 4) accumulator with a float4 atomic a tap took
// 0.467 ms but needs a 0.34 ms split into three cubes and a third more
// memory, for 0.76 ms saved over a 10,000-particle run.)
#include "scatter_common.cuh"

using namespace xm;

namespace xt {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;

__global__ void __launch_bounds__(kThreads)
tri_scatter_kernel(const float* __restrict__ zi, const float* __restrict__ yi,
                   const float* __restrict__ xi, const float* __restrict__ v0,
                   const float* __restrict__ v1, const float* __restrict__ v2,
                   float* __restrict__ c0, float* __restrict__ c1,
                   float* __restrict__ c2, int64_t m, int p) {
  const float* __restrict__ v = pick((int)blockIdx.y, v0, v1, v2);
  float* __restrict__ c = pick((int)blockIdx.y, c0, c1, c2);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const float z = zi[i], y = yi[i], x = xi[i];
    const int z0 = (int)floorf(z), y0 = (int)floorf(y), x0 = (int)floorf(x);
    const float fz = z - (float)z0, fy = y - (float)y0, fx = x - (float)x0;
    const float a = v[i];
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const int zj = z0 + dz;
      if (zj < 0 || zj >= p) continue;
      const float wz = dz ? fz : 1.0f - fz;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int yj = y0 + dy;
        if (yj < 0 || yj >= p) continue;
        const float wzy = wz * (dy ? fy : 1.0f - fy);
        add_row2(c + ((int64_t)zj * p + yj) * p, x0, p,
                 wzy * (1.0f - fx) * a, wzy * fx * a);
      }
    }
  }
}

unsigned blocks_for(int64_t m) {
  const int64_t b = (m + kThreads - 1) / kThreads;
  return (unsigned)(b > kMaxBlocks ? kMaxBlocks : b);
}

}  // namespace xt

extern "C" int xm_tri_scatter(const float* zi, const float* yi, const float* xi,
                              const float* v0, const float* v1, const float* v2,
                              float* c0, float* c1, float* c2, int64_t m, int p,
                              void* stream) {
  xt::tri_scatter_kernel<<<dim3(xt::blocks_for(m), 3), xt::kThreads, 0,
                           (cudaStream_t)stream>>>(zi, yi, xi, v0, v1, v2, c0,
                                                   c1, c2, m, p);
  return (int)cudaGetLastError();
}
