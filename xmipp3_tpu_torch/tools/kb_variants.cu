// K3's first design for kb_variants.py beside this file, which holds it
// against the plain version and times it in turns on one card beside the
// package's kernel (csrc/scatter_kb.cu, included here for its window and
// launch constants):
//   xv_kb_v0       a thread a sample, a scalar atomic per live tap into
//                  each of the three cubes in turn
#include "scatter_kb.cu"

namespace first {

constexpr int kPolyTerms = 8;

__global__ void kb_scatter_kernel(const float* __restrict__ zi,
                                  const float* __restrict__ yi,
                                  const float* __restrict__ xi,
                                  const float* __restrict__ v0,
                                  const float* __restrict__ v1,
                                  const float* __restrict__ v2,
                                  float* __restrict__ c0,
                                  float* __restrict__ c1,
                                  float* __restrict__ c2, int64_t m, int p,
                                  float r2, xk::Poly poly) {
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
}  // namespace first

namespace {

using xk::Poly;
using xk::kThreads;

unsigned blocks_for(int64_t m) {
  int64_t b = (m + kThreads - 1) / kThreads;
  return (unsigned)(b > xk::kMaxBlocks ? xk::kMaxBlocks : (b < 1 ? 1 : b));
}

Poly poly_of(const float* host) {
  Poly poly;
  for (int k = 0; k < xk::kPolyTerms; ++k) poly.c[k] = host[k];
  return poly;
}

}  // namespace

extern "C" int xv_kb_v0(const float* zi, const float* yi, const float* xi,
                        const float* v0, const float* v1, const float* v2,
                        float* c0, float* c1, float* c2, int64_t m, int p,
                        float r2, const float* poly_host, void* stream) {
  first::kb_scatter_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      zi, yi, xi, v0, v1, v2, c0, c1, c2, m, p, r2, poly_of(poly_host));
  return (int)cudaGetLastError();
}
