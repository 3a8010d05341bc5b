// K2: trilinear gridding of raw Fourier samples into a (3, P, P, P) cube.
//
// Replaces the Pallas kernel _tri_kernel of xmipp3_tpu/ops/pallas_scatter_tri.py
// (reached through tri_scatter_packed). That kernel sorts the raw samples,
// expands the four in-plane taps after the sort, streams each tile's rows
// once and carries the dz = 1 taps in a lag ring, all in a packed
// (ntiles, 128, 96) layout built for the TPU's one-hot MXU products. None of
// that carries over: here one thread takes one sample, computes its floor
// corner and fractions, and adds its 8 corner taps to the three channels
// with 24 float atomics. A corner outside [0, P) on any axis is skipped, the
// per-axis mask of xmipp3_tpu/ops/reconstruct.py:254-256 (the XLA path the
// tests hold this kernel against); the TPU kernel masked x+1 and y+1 through
// its flat base and let z+1 spill into padding, which differs only at the
// |k| = Nyquist edge.
//
// Bound on the card: 24 bytes read per sample and the three cubes read and
// written once are the bytes; the 24 float atomics per sample, resolved in
// L2, are what sets the time in practice. Threads of one warp hold
// neighbouring samples of one slice, so their taps fall on neighbouring
// voxels and share L2 lines.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void tri_scatter_kernel(const float* __restrict__ zi,
                                   const float* __restrict__ yi,
                                   const float* __restrict__ xi,
                                   const float* __restrict__ v0,
                                   const float* __restrict__ v1,
                                   const float* __restrict__ v2,
                                   float* __restrict__ c0,
                                   float* __restrict__ c1,
                                   float* __restrict__ c2, int64_t m, int p) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const float z = zi[i], y = yi[i], x = xi[i];
    const int z0 = (int)floorf(z), y0 = (int)floorf(y), x0 = (int)floorf(x);
    const float fz = z - (float)z0, fy = y - (float)y0, fx = x - (float)x0;
    const float a = v0[i], b = v1[i], c = v2[i];
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
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int xj = x0 + dx;
          if (xj < 0 || xj >= p) continue;
          const float w = wzy * (dx ? fx : 1.0f - fx);
          const int64_t flat = ((int64_t)zj * p + yj) * p + xj;
          atomicAdd(c0 + flat, w * a);
          atomicAdd(c1 + flat, w * b);
          atomicAdd(c2 + flat, w * c);
        }
      }
    }
  }
}

}  // namespace

extern "C" int xm_tri_scatter(const float* zi, const float* yi, const float* xi,
                              const float* v0, const float* v1, const float* v2,
                              float* c0, float* c1, float* c2, int64_t m, int p,
                              void* stream) {
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  tri_scatter_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      zi, yi, xi, v0, v1, v2, c0, c1, c2, m, p);
  return (int)cudaGetLastError();
}
