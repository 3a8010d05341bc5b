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
// axis is dropped whole; a tap outside [0, P) on any axis is never written.
//
// Bound on the card: neither the bytes (24 read per sample, the touched
// voxels of the three cubes read and written once) nor the 64 Horner
// evaluations a sample. The float atomics are, resolved in L2 at one
// request per 32-byte sector a warp's instruction touches. The first design
// sent a scalar atomic per live tap into each of the three cubes in turn:
// 139 M adds in 4.10 ms on an H100 SXM at 700 W, 53 times its sector
// bound. This design sends fewer requests, to one cube at a time (measured
// with tools/kb_variants.py on the same card, one 256-image batch at P=256):
//
// - The channel is blockIdx.y (xm::pick), which the card schedules after
//   all of blockIdx.x: one 64 MiB cube is walked at a time, not three
//   interleaved. Each channel recomputes the window (3 x 64 Horner
//   evaluations a sample, about 4 GFLOP, far below the atomics' cost).
//   Alone: 4.10 -> 1.70 ms.
// - A (dz, dy) row's four taps lie on four consecutive floats of the cube
//   and go out together through xm::add_row4, as the float4 atomics of the
//   one or two 16-byte quads that hold them: 1.70 -> 1.12 ms. (A float4
//   where the row is 16-byte aligned, two float2 where it is 8-byte aligned
//   and add, float2, add elsewhere took 1.18 ms; one interleaved
//   (P, P, P, 4) accumulator with a float4 a live tap 1.28 ms, and 0.33 ms
//   more to split it into three cubes.) A row wholly outside the blob is
//   not sent; its dead taps ride in the quads with weight 0.
//
// kz-slab mode (the TPU kernel's zdim and z_lo, which the mesh
// reconstructors use): the three cubes are slabs of zdim planes of P x P
// whose first plane is the absolute plane z_lo of the full cube. The
// whole-sample drop still tests the floor corner against [0, P) on every
// axis; a tap is kept where its absolute plane lies in [z_lo, z_lo + zdim),
// and its row is addressed relative to the slab. zdim = P, z_lo = 0 is the
// full cube. A slab may start anywhere in an allocation: add_row4 takes the
// quad from the address.
#include "scatter_common.cuh"

using namespace xm;

namespace xk {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;
constexpr int kPolyTerms = 8;

struct Poly {
  float c[kPolyTerms];  // highest power first, as numpy.polyfit returns them
};

// The window at squared distance d2: 0 beyond r^2, the polynomial clamped
// at 0 inside.
__device__ __forceinline__ float window(float d2, float r2, const Poly& poly) {
  if (d2 > r2) return 0.0f;
  float w = 0.0f;
#pragma unroll
  for (int k = 0; k < kPolyTerms; ++k) w = w * d2 + poly.c[k];
  return fmaxf(w, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
kb_scatter_kernel(const float* __restrict__ zi, const float* __restrict__ yi,
                  const float* __restrict__ xi, const float* __restrict__ v0,
                  const float* __restrict__ v1, const float* __restrict__ v2,
                  float* __restrict__ c0, float* __restrict__ c1,
                  float* __restrict__ c2, int64_t m, int p, int zdim,
                  int z_lo, float r2, Poly poly) {
  const float* __restrict__ v = pick((int)blockIdx.y, v0, v1, v2);
  float* __restrict__ c = pick((int)blockIdx.y, c0, c1, c2);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const float z = zi[i], y = yi[i], x = xi[i];
    const int z0 = (int)floorf(z), y0 = (int)floorf(y), x0 = (int)floorf(x);
    if (z0 < 0 || z0 >= p || y0 < 0 || y0 >= p || x0 < 0 || x0 >= p) continue;
    const float fz = z - (float)z0, fy = y - (float)y0, fx = x - (float)x0;
    const float a = v[i];
#pragma unroll
    for (int dz = -1; dz <= 2; ++dz) {
      const int zs = z0 + dz - z_lo;  // the tap's plane in the slab
      if (zs < 0 || zs >= zdim) continue;
      const float ddz = (float)dz - fz;
      const float dz2 = ddz * ddz;
#pragma unroll
      for (int dy = -1; dy <= 2; ++dy) {
        const int yj = y0 + dy;
        if (yj < 0 || yj >= p) continue;
        const float ddy = (float)dy - fy;
        const float dzy2 = dz2 + ddy * ddy;
        if (dzy2 > r2) continue;  // the whole row lies outside the blob
        float u[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float ddx = (float)(t - 1) - fx;
          u[t] = window(dzy2 + ddx * ddx, r2, poly) * a;
        }
        add_row4(c + ((int64_t)zs * p + yj) * p, x0 - 1, p,
                 make_float4(u[0], u[1], u[2], u[3]));
      }
    }
  }
}

}  // namespace xk

extern "C" int xm_kb_scatter(const float* zi, const float* yi, const float* xi,
                             const float* v0, const float* v1, const float* v2,
                             float* c0, float* c1, float* c2, int64_t m, int p,
                             int zdim, int z_lo, float r2,
                             const float* poly_host, void* stream) {
  xk::Poly poly;
  for (int k = 0; k < xk::kPolyTerms; ++k) poly.c[k] = poly_host[k];
  int64_t blocks = (m + xk::kThreads - 1) / xk::kThreads;
  if (blocks > xk::kMaxBlocks) blocks = xk::kMaxBlocks;
  xk::kb_scatter_kernel<<<dim3((unsigned)blocks, 3), xk::kThreads, 0,
                          (cudaStream_t)stream>>>(zi, yi, xi, v0, v1, v2, c0,
                                                  c1, c2, m, p, zdim, z_lo,
                                                  r2, poly);
  return (int)cudaGetLastError();
}
