// K4: weighted complex cross-spectrum of ring FFTs,
//   cross  [b, R, k] = sum_r  fi[b, r, k]       * w[r] * conj(fr[R, r, k])
//   cross_m[b, R, k] = sum_r  conj(fi[b, r, k]) * w[r] * conj(fr[R, r, k])
// the contraction at the heart of projection matching (ops/match.py).
//
// Replaces the Pallas kernel _kernel of xmipp3_tpu/ops/pallas_cross.py
// (reached through cross_spectrum_pallas). That kernel transposes the
// operands to (k, B, nr) / (k, nr, R), pads nr, B and R to the 128-wide
// matrix unit and runs four real matrix products per grid cell. None of the
// layout work is carried over: the data stays as it lies, k fastest in
// (B, nr, k) complex64. With fi = a + ib (times w) and fr = c + id, both
// spectra come from the same four real products, accumulated in float32
// registers in a fixed order over r (no atomics, no TF32, no bf16: lower
// precision flips the gallery's argmax winners):
//   cross   = (ac + bd,  bc - ad)       cross_m = (ac - bd, -(bc + ad))
//
// Bound on the card: bytes. The two output spectra (2 x B x R x k
// complex64, 866 MB at the matching run's B=512, R=1652, k=64, nr=31) are
// 25 times the inputs and are written once (0.27 ms at 3.35 TB/s; written
// alone by PyTorch they take 0.27 ms); the 4 float32 FMAs per ring and
// output pair need 0.20 ms at 67 TFLOP/s.
//
// The first design (8 images x 16 references x 32 harmonics a block,
// 8-byte cp.async copies, the weight applied per thread and ring) lost to
// two complex einsums, 1.02 against 0.92 ms (H100 SXM at 700 W): its small
// tile read every image's rings from L2 104 times and every reference's 64
// times, 2.5 GB a launch. This design (0.655 ms on the same card, measured
// with tools/cross_variants.py beside the first design and the einsums):
//
// - A block tile of 32 images x 32 references x 4 harmonics. The L2 ->
//   shared traffic is 8 nr k (B ceil(R/TR) + R ceil(B/TB)) bytes: 0.84 GB
//   at the matching run's shapes, a third of the first design's. Four
//   harmonics are one 32-byte sector of a (b, R) output row, so every store
//   fills whole sectors. (16 x 32 x 8 took 0.765 ms, 32 x 64 x 4 with 512
//   threads and one block an SM 0.712.)
// - A warp is 4 harmonics x 2 image groups x 4 reference groups; each
//   thread holds a 4 x 4 register tile of (image, reference) pairs at one
//   harmonic, its rows interleaved with the other groups' (row g + 8 i), so
//   that a warp's operand load reads 8 or 16 neighbouring complex values,
//   broadcast to the lanes that share them. 128 registers, two blocks an
//   SM. (8 x 4 and 4 x 8 register tiles at three blocks an SM spilled and
//   took 0.67-0.71 ms.)
// - The rings come in through four stages of 8 rings each, all in flight
//   at once for nr = 31, with 16-byte cp.async copies (two harmonics; 8-byte
//   copies took 0.753 ms). Operands that are not 16-byte aligned, or an odd
//   k, take the 8-byte copies of the same kernel.
// - The ring weight multiplies the image tile once, in shared memory, as a
//   stage lands (the same product a * w[r] as the plain version's).
// - Plain stores: streaming ones (st.global.cs) took 3 % longer. A
//   persistent grid, with or without the outputs staged in shared memory
//   and stored while the next tile computes, took 0.75-0.93 ms.
//
// The ragged edges of B, R, k and nr are zero-filled by the copies and
// skipped on store.
//
// C interface (bound with ctypes from ops/cross.py): returns
// cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace xc {

// A block's tile: TB images x TR references x KC harmonics. A thread owns
// one harmonic and RB x RR (image, reference) pairs; a warp is KC
// harmonics x LB image groups x LR reference groups, a block WB x WR warps.
// Rings come in stages of RC, NS stages in flight; MINB blocks an SM.
constexpr int KC = 4, LB = 2, LR = 4, WB = 4, WR = 2;
constexpr int RB = 4, RR = 4, RC = 8, NS = 4, MINB = 2;
constexpr int GB = LB * WB, GR = LR * WR;  // thread groups
constexpr int TB = RB * GB, TR = RR * GR;  // tile rows: 32 x 32
constexpr int kThreads = 32 * WB * WR;
constexpr int kStageI = RC * TB * KC;      // float2 of a stage's images
constexpr int kStage = RC * (TB + TR) * KC;
constexpr int kSmemBytes = NS * kStage * (int)sizeof(float2);
static_assert(KC * LB * LR == 32, "a warp is KC x LB x LR lanes");
static_assert(KC % 2 == 0, "16-byte copies move two harmonics");

// cp.async of VEC bytes (8: one complex value, 16: two) global -> shared;
// zero-fills when !valid.
template <int VEC>
__device__ __forceinline__ void copy_async(float2* dst, const float2* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  }
}

struct Shape {
  int B, nr, R, K;
  int nk, nR;  // tiles along k (fastest, blockIdx.x % nk), R, then B
};

// Copy rows [row0, row0 + ROWS) of rings [r0, r0 + RC) at harmonics
// [k0, k0 + KC) of src (rows x nr x K) into dst[rc][row][KC]; rows at or
// past `rows` are zeros.
template <int ROWS, int VEC>
__device__ __forceinline__ void stage_rows(float2* dst, const float2* src,
                                           int row0, int rows, int r0,
                                           int k0, const Shape& s) {
  constexpr int E = VEC / 8;          // complex values a copy moves
  constexpr int CPR = KC / E;         // copies a ring row
  constexpr int N = RC * ROWS * CPR;
#pragma unroll
  for (int it = 0; it < (N + kThreads - 1) / kThreads; ++it) {
    const int c = (int)threadIdx.x + it * kThreads;
    if (N % kThreads == 0 || c < N) {
      const int e = c % CPR, row = (c / CPR) % ROWS, rc = c / (CPR * ROWS);
      const int r = r0 + rc, q = row0 + row, k = k0 + e * E;
      const bool ok = r < s.nr && q < rows && k < s.K;
      copy_async<VEC>(dst + (rc * ROWS + row) * KC + e * E,
                      ok ? src + ((size_t)q * s.nr + r) * s.K + k : src, ok);
    }
  }
}

template <int VEC, bool MIRROR>
__global__ void __launch_bounds__(kThreads, MINB)
cross_spectrum_kernel(const float2* __restrict__ fi,
                      const float2* __restrict__ fr,
                      const float* __restrict__ w, float2* __restrict__ cross,
                      float2* __restrict__ cross_m, Shape s) {
  // NS stages, each s_i[RC][TB][KC] followed by s_r[RC][TR][KC]
  extern __shared__ __align__(16) float2 smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kx = lane % KC;
  const int gb = (warp % WB) * LB + (lane / KC) % LB;
  const int gr = (warp / WB) * LR + lane / (KC * LB);
  const int rest = (int)blockIdx.x / s.nk;
  const int k0 = ((int)blockIdx.x - rest * s.nk) * KC;
  const int R0 = (rest % s.nR) * TR, b0 = (rest / s.nR) * TB;
  const int nst = max((s.nr + RC - 1) / RC, 1);  // ring stages

  auto issue = [&](int g) {  // start the copies of stage g into g % NS
    if (g < nst) {
      float2* s_i = smem + (g % NS) * kStage;
      stage_rows<TB, VEC>(s_i, fi, b0, s.B, g * RC, k0, s);
      stage_rows<TR, VEC>(s_i + kStageI, fr, R0, s.R, g * RC, k0, s);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float ac[RB][RR], bd[RB][RR], bc[RB][RR], ad[RB][RR];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < RR; ++j) ac[i][j] = bd[i][j] = bc[i][j] = ad[i][j] = 0.f;

  for (int g = 0; g < NS - 1; ++g) issue(g);
  for (int g = 0; g < nst; ++g) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2) : "memory");
    __syncthreads();  // stage g is in, and stage g - 1's buffer is consumed
    issue(g + NS - 1);
    float2* s_i = smem + (g % NS) * kStage;
    const float2* s_r = s_i + kStageI;
    // the ring weight, once per image value
#pragma unroll
    for (int it = 0; it < (kStageI + kThreads - 1) / kThreads; ++it) {
      const int c = (int)threadIdx.x + it * kThreads;
      const int r = g * RC + c / (TB * KC);
      if ((kStageI % kThreads == 0 || c < kStageI) && r < s.nr) {
        const float wr = __ldg(w + r);
        s_i[c].x *= wr;
        s_i[c].y *= wr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int rc = 0; rc < RC; ++rc) {
      float2 p[RB], q[RR];
#pragma unroll
      for (int i = 0; i < RB; ++i) p[i] = s_i[(rc * TB + gb + GB * i) * KC + kx];
#pragma unroll
      for (int j = 0; j < RR; ++j) q[j] = s_r[(rc * TR + gr + GR * j) * KC + kx];
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
  }

  const int k = k0 + kx;
  if (k >= s.K) return;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int b = b0 + gb + GB * i;
    if (b >= s.B) continue;
#pragma unroll
    for (int j = 0; j < RR; ++j) {
      const int q = R0 + gr + GR * j;
      if (q >= s.R) continue;
      const size_t o = ((size_t)b * s.R + q) * s.K + k;
      cross[o] = make_float2(ac[i][j] + bd[i][j], bc[i][j] - ad[i][j]);
      if (MIRROR)
        cross_m[o] = make_float2(ac[i][j] - bd[i][j], -(bc[i][j] + ad[i][j]));
    }
  }
}

template <int VEC, bool MIRROR>
int launch(const float2* fi, const float2* fr, const float* w, float2* cross,
           float2* cross_m, int B, int nr, int R, int K, cudaStream_t stream) {
  const auto kernel = cross_spectrum_kernel<VEC, MIRROR>;
  // more than 48 KB of shared memory has to be asked for, per kernel
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (rc != cudaSuccess) return (int)rc;
  const Shape s{B, nr, R, K, (K + KC - 1) / KC, (R + TR - 1) / TR};
  const long long tiles = (long long)s.nk * s.nR * ((B + TB - 1) / TB);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, kThreads, kSmemBytes, stream>>>(fi, fr, w, cross,
                                                            cross_m, s);
  return (int)cudaGetLastError();
}

// 16-byte copies need both operands on a 16-byte boundary and an even k
// (so that every ring row starts on one)
inline bool aligned16(const void* fi, const void* fr, int K) {
  return ((reinterpret_cast<uintptr_t>(fi) |
           reinterpret_cast<uintptr_t>(fr)) & 15) == 0 && K % 2 == 0;
}

}  // namespace xc

// fi (B, nr, K), fr (R, nr, K), cross and cross_m (B, R, K): complex64 as
// interleaved float pairs, 8-byte aligned; w (nr,) float32. cross_m may be
// null: then only the straight spectrum is computed.
extern "C" int xm_cross_spectrum(const void* fi, const void* fr, const float* w,
                                 void* cross, void* cross_m, int B, int nr,
                                 int R, int K, void* stream) {
  const auto a = static_cast<const float2*>(fi);
  const auto b = static_cast<const float2*>(fr);
  const auto o = static_cast<float2*>(cross);
  const auto om = static_cast<float2*>(cross_m);
  const auto st = (cudaStream_t)stream;
  const bool v16 = xc::aligned16(fi, fr, K);
  if (cross_m != nullptr)
    return v16 ? xc::launch<16, true>(a, b, w, o, om, B, nr, R, K, st)
               : xc::launch<8, true>(a, b, w, o, om, B, nr, R, K, st);
  return v16 ? xc::launch<16, false>(a, b, w, o, nullptr, B, nr, R, K, st)
             : xc::launch<8, false>(a, b, w, o, nullptr, B, nr, R, K, st);
}
