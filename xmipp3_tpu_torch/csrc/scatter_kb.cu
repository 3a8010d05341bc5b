// K3: direct Kaiser-Bessel gridding of raw Fourier samples, 4x4x4 taps.
//
// Replaces the Pallas kernel built by _mk_kernel in
// xmipp3_tpu/ops/pallas_scatter_kb.py (reached through kb_scatter_3ch). That
// kernel sorts the samples by base voxel, runs four dz passes over 8192-voxel
// tiles and accumulates one-hot MXU products of 1024-sample DMA blocks. Here
// one thread takes one sample and walks its 64 taps at offsets -1..2 from the
// floor corner. The weight is the same degree-7 polynomial in d^2 as on the
// TPU (coefficients from _window_poly, passed in), clamped at 0 and zero
// where d^2 > r^2. A sample whose floor corner lies outside [0, P) on any
// axis is dropped whole; a tap outside [0, P) on any axis is skipped.
//
// Bound on the card: 24 bytes read per sample and the three cubes read and
// written once are the bytes, and 64 Horner evaluations per sample the
// arithmetic; neither is close to the time. The up to 64 x 3 float atomics
// per sample, resolved in L2, are what sets it. Neighbouring threads hold
// neighbouring samples of one slice, so a warp's taps share L2 lines.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPolyTerms = 8;

struct Poly {
  float c[kPolyTerms];  // highest power first, as numpy.polyfit returns them
};

__global__ void kb_scatter_kernel(const float* __restrict__ zi,
                                  const float* __restrict__ yi,
                                  const float* __restrict__ xi,
                                  const float* __restrict__ v0,
                                  const float* __restrict__ v1,
                                  const float* __restrict__ v2,
                                  float* __restrict__ c0,
                                  float* __restrict__ c1,
                                  float* __restrict__ c2, int64_t m, int p,
                                  float r2, Poly poly) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const float z = zi[i], y = yi[i], x = xi[i];
    const int z0 = (int)floorf(z), y0 = (int)floorf(y), x0 = (int)floorf(x);
    if (z0 < 0 || z0 >= p || y0 < 0 || y0 >= p || x0 < 0 || x0 >= p) continue;
    const float fz = z - (float)z0, fy = y - (float)y0, fx = x - (float)x0;
    const float a = v0[i], b = v1[i], c = v2[i];
#pragma unroll
    for (int dz = -1; dz <= 2; ++dz) {
      const int zj = z0 + dz;
      if (zj < 0 || zj >= p) continue;
      const float ddz = (float)dz - fz;
      const float dz2 = ddz * ddz;
#pragma unroll
      for (int dy = -1; dy <= 2; ++dy) {
        const int yj = y0 + dy;
        if (yj < 0 || yj >= p) continue;
        const float ddy = (float)dy - fy;
        const float dzy2 = dz2 + ddy * ddy;
        const int64_t row = ((int64_t)zj * p + yj) * p;
#pragma unroll
        for (int dx = -1; dx <= 2; ++dx) {
          const int xj = x0 + dx;
          if (xj < 0 || xj >= p) continue;
          const float ddx = (float)dx - fx;
          const float d2 = dzy2 + ddx * ddx;
          if (d2 > r2) continue;
          float w = 0.0f;
#pragma unroll
          for (int k = 0; k < kPolyTerms; ++k) w = w * d2 + poly.c[k];
          w = fmaxf(w, 0.0f);
          const int64_t flat = row + xj;
          atomicAdd(c0 + flat, w * a);
          atomicAdd(c1 + flat, w * b);
          atomicAdd(c2 + flat, w * c);
        }
      }
    }
  }
}

}  // namespace

extern "C" int xm_kb_scatter(const float* zi, const float* yi, const float* xi,
                             const float* v0, const float* v1, const float* v2,
                             float* c0, float* c1, float* c2, int64_t m, int p,
                             float r2, const float* poly_host, void* stream) {
  Poly poly;
  for (int k = 0; k < kPolyTerms; ++k) poly.c[k] = poly_host[k];
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  kb_scatter_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      zi, yi, xi, v0, v1, v2, c0, c1, c2, m, p, r2, poly);
  return (int)cudaGetLastError();
}
