// K4: weighted complex cross-spectrum of ring FFTs,
//   cross  [b, R, k] = sum_r  fi[b, r, k]       * w[r] * conj(fr[R, r, k])
//   cross_m[b, R, k] = sum_r  conj(fi[b, r, k]) * w[r] * conj(fr[R, r, k])
// the contraction at the heart of projection matching (ops/match.py).
//
// Replaces the Pallas kernel _kernel of xmipp3_tpu/ops/pallas_cross.py
// (reached through cross_spectrum_pallas). That kernel transposes the
// operands to (k, B, nr) / (k, nr, R), pads nr, B and R to the 128-wide
// matrix unit and runs four real matrix products per grid cell. None of the
// layout work is carried over: here the data stays as it lies, k fastest in
// (B, nr, k) complex64, and one thread owns one harmonic k, so that every
// global load and store of a warp is a run of 32 neighbouring complex values
// (256 bytes). With fi = a + ib (times w) and fr = c + id, both spectra come
// from the same four real products, accumulated in float32 registers in a
// fixed order over r (no atomics, no lower precision):
//   cross   = (ac + bd,  bc - ad)       cross_m = (ac - bd, -(bc + ad))
//
// Tiling: a block computes 8 images x 16 references x 32 harmonics with
// 256 threads (32 harmonics x 2 x 4 groups), each thread a 4 x 4 register
// tile of (image, reference) pairs. The rings are staged through shared
// memory eight at a time (48 KB a stage: 8 x (8 + 16) x 32 complex values)
// in two buffers: while a stage is consumed, cp.async brings the next one
// in, so the loads' latency hides behind the FMAs at the two blocks an SM
// that 126 registers a thread allow. The ring weight multiplies the image
// operand as it leaves shared memory. The ragged edges of B, R, k and nr
// are zero-filled by the copies and skipped on store.
//
// Bound on the card: bytes. The four output planes (2 x B x R x k complex64)
// are 40 times the inputs and are written once; at 8 flop per ring and
// output pair the float32 work takes about three quarters of the time the
// writes need, so a kernel that keeps the FMA pipe busy while it streams the
// outputs is within reach of the byte bound.
//
// C interface (bound with ctypes from ops/cross.py): returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// fi (B, nr, K), fr (R, nr, K), cross and cross_m (B, R, K): complex64 as
// interleaved float pairs; w (nr,) float32. cross_m may be null: then only
// the straight spectrum is computed.
extern "C" int xm_cross_spectrum(const void* fi, const void* fr, const float* w,
                                 void* cross, void* cross_m, int B, int nr,
                                 int R, int K, void* stream) {
  const dim3 grid((R + TR - 1) / TR, (B + TB - 1) / TB, (K + KC - 1) / KC);
  const dim3 block(KC, GB * GR);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  if (cross_m != nullptr)
    return launch<true>(grid, block, (cudaStream_t)stream, (const float2*)fi,
                        (const float2*)fr, w, (float2*)cross, (float2*)cross_m,
                        B, nr, R, K);
  return launch<false>(grid, block, (cudaStream_t)stream, (const float2*)fi,
                       (const float2*)fr, w, (float2*)cross, nullptr, B, nr, R,
                       K);
}
