// K2's first design, for tri_variants.py beside this file, which holds it
// against the plain version and times it in turns on one card beside the
// package's kernel (csrc/scatter_tri.cu, included here: three planar cubes,
// the channel in blockIdx.y and a row's two taps through xm::add_row2):
//   xv_tri_v0      a thread a sample, 24 scalar atomics, the three cubes
//                  interleaved in time
#include "scatter_tri.cu"

namespace first {

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

}  // namespace first

extern "C" int xv_tri_v0(const float* zi, const float* yi, const float* xi,
                         const float* v0, const float* v1, const float* v2,
                         float* c0, float* c1, float* c2, int64_t m, int p,
                         void* stream) {
  first::tri_scatter_kernel<<<xt::blocks_for(m), xt::kThreads, 0,
                              (cudaStream_t)stream>>>(zi, yi, xi, v0, v1, v2,
                                                      c0, c1, c2, m, p);
  return (int)cudaGetLastError();
}
