// K4 variants for cross_variants.py beside this file, which holds each
// against the plain version and times them in turns on one card beside the
// package's kernel (csrc/cross.cu, included here):
//   xv_cross_v0      the first design: 8 images x 16 references x
//                    32 harmonics a block, 8-byte cp.async copies in two
//                    buffers, the ring weight applied per thread and ring
//   xv_cross_8byte   the package's kernel with the 8-byte copies it takes
//                    for operands off a 16-byte boundary or an odd k
#include "cross.cu"

namespace first {

constexpr int KC = 32;           // harmonics per block: one warp along k
constexpr int RB = 4, RR = 4;    // register tile: images x references
constexpr int GB = 2, GR = 4;    // thread groups along images x references
constexpr int TB = RB * GB;      // 8 images per block
constexpr int TR = RR * GR;      // 16 references per block
constexpr int RC = 8;            // rings per shared-memory stage
constexpr int kThreads = KC * GB * GR;
constexpr int kStage = RC * (TB + TR) * KC;          // float2 per stage
constexpr int kSmemBytes = 2 * kStage * (int)sizeof(float2);

// 8-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void copy_async(float2* dst, const float2* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

template <bool MIRROR>
__global__ void __launch_bounds__(kThreads)
cross_spectrum_kernel(const float2* __restrict__ fi,
                      const float2* __restrict__ fr,
                      const float* __restrict__ w, float2* __restrict__ cross,
                      float2* __restrict__ cross_m, int B, int nr, int R,
                      int K) {
  // two stages, each s_i[RC][TB][KC] followed by s_r[RC][TR][KC]
  extern __shared__ float2 smem[];

  const int kx = threadIdx.x;             // harmonic inside the block
  const int gb = threadIdx.y / GR;        // group along the images
  const int gr = threadIdx.y % GR;        // group along the references
  const int tid = threadIdx.y * KC + kx;
  const int k0 = blockIdx.z * KC;
  const int b0 = blockIdx.y * TB;
  const int R0 = blockIdx.x * TR;

  // start the copies of the rings [r0, r0 + RC) into buffer `buf`
  auto stage_in = [&](int buf, int r0) {
    float2* s_i = smem + buf * kStage;
    float2* s_r = s_i + RC * TB * KC;
    for (int t = tid; t < RC * TB * KC; t += kThreads) {
      const int kk = t % KC, row = (t / KC) % TB, rc = t / (KC * TB);
      const int r = r0 + rc, b = b0 + row, k = k0 + kk;
      const bool ok = r < nr && b < B && k < K;
      copy_async(s_i + t, ok ? fi + ((size_t)b * nr + r) * K + k : fi, ok);
    }
    for (int t = tid; t < RC * TR * KC; t += kThreads) {
      const int kk = t % KC, row = (t / KC) % TR, rc = t / (KC * TR);
      const int r = r0 + rc, q = R0 + row, k = k0 + kk;
      const bool ok = r < nr && q < R && k < K;
      copy_async(s_r + t, ok ? fr + ((size_t)q * nr + r) * K + k : fr, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float ac[RB][RR], bd[RB][RR], bc[RB][RR], ad[RB][RR];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < RR; ++j) ac[i][j] = bd[i][j] = bc[i][j] = ad[i][j] = 0.f;

  stage_in(0, 0);
  int buf = 0;
  for (int r0 = 0; r0 < nr; r0 += RC, buf ^= 1) {
    if (r0 + RC < nr) {
      stage_in(buf ^ 1, r0 + RC);  // consumed two syncs ago
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // every thread's copies of this stage have landed
    const float2* s_i = smem + buf * kStage;
    const float2* s_r = s_i + RC * TB * KC;
#pragma unroll
    for (int rc = 0; rc < RC; ++rc) {
      const float wr = r0 + rc < nr ? __ldg(w + r0 + rc) : 0.f;
      float2 p[RB], q[RR];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        p[i] = s_i[(rc * TB + gb * RB + i) * KC + kx];
        p[i].x *= wr;
        p[i].y *= wr;
      }
#pragma unroll
      for (int j = 0; j < RR; ++j) q[j] = s_r[(rc * TR + gr * RR + j) * KC + kx];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < RR; ++j) {
          ac[i][j] = fmaf(p[i].x, q[j].x, ac[i][j]);
          bd[i][j] = fmaf(p[i].y, q[j].y, bd[i][j]);
          bc[i][j] = fmaf(p[i].y, q[j].x, bc[i][j]);
          ad[i][j] = fmaf(p[i].x, q[j].y, ad[i][j]);
        }
    }
    __syncthreads();  // this stage is consumed: its buffer may be refilled
  }

  const int k = k0 + kx;
  if (k >= K) return;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int b = b0 + gb * RB + i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < RR; ++j) {
      const int q = R0 + gr * RR + j;
      if (q >= R) continue;
      const size_t o = ((size_t)b * R + q) * K + k;
      cross[o] = make_float2(ac[i][j] + bd[i][j], bc[i][j] - ad[i][j]);
      if (MIRROR)
        cross_m[o] = make_float2(ac[i][j] - bd[i][j], -(bc[i][j] + ad[i][j]));
    }
  }
}

template <bool MIRROR>
int launch(const dim3 grid, const dim3 block, cudaStream_t stream,
           const float2* fi, const float2* fr, const float* w, float2* cross,
           float2* cross_m, int B, int nr, int R, int K) {
  // more than 48 KB of shared memory has to be asked for, per kernel
  cudaError_t rc = cudaFuncSetAttribute(
      cross_spectrum_kernel<MIRROR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  cross_spectrum_kernel<MIRROR><<<grid, block, kSmemBytes, stream>>>(
      fi, fr, w, cross, cross_m, B, nr, R, K);
  return (int)cudaGetLastError();
}
}  // namespace first

extern "C" int xv_cross_v0(const void* fi, const void* fr, const float* w,
                           void* cross, void* cross_m, int B, int nr, int R,
                           int K, void* stream) {
  using namespace first;
  const dim3 grid((R + TR - 1) / TR, (B + TB - 1) / TB, (K + KC - 1) / KC);
  const dim3 block(KC, GB * GR);
  return launch<true>(grid, block, (cudaStream_t)stream, (const float2*)fi,
                      (const float2*)fr, w, (float2*)cross, (float2*)cross_m,
                      B, nr, R, K);
}

extern "C" int xv_cross_8byte(const void* fi, const void* fr, const float* w,
                              void* cross, void* cross_m, int B, int nr,
                              int R, int K, void* stream) {
  return xc::launch<8, true>(
      (const float2*)fi, (const float2*)fr, w, (float2*)cross,
      (float2*)cross_m, B, nr, R, K, (cudaStream_t)stream);
}
