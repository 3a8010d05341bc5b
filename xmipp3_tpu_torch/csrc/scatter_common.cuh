// Device code shared by the scatter kernels: the range-checked float atomic,
// the 8-byte vector atomic for two neighbouring voxels, the warp-aggregated
// add, the vector atomics of a row of two or four voxels and the channel
// selection of a channel-per-block-row grid.
//
// All of it serves one fact of the card: a float atomic resolves in L2 on a
// 32-byte sector, a warp's atomic costs one L2 request per sector its lanes
// touch, and a sector that is not resident is read from device memory and
// later written back. What a scatter can save is sector requests, not
// arithmetic: walk one accumulator at a time (`pick` with the channel in
// blockIdx.y, which the card schedules after all of blockIdx.x), put taps
// that are x-neighbours into one vector atomic (`add_pair`, `add_row2`,
// `add_row4`), and sum the updates a warp holds for one voxel before they
// leave the SM (`add_warp`).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace xm {

__device__ __forceinline__ bool in_range(int32_t j, int64_t s) {
  return j >= 0 && j < s;
}

// c[j] += a; an index outside [0, s) is dropped.
__device__ __forceinline__ void add(float* __restrict__ c, int32_t j,
                                    int64_t s, float a) {
  if (in_range(j, s)) atomicAdd(c + j, a);
}

// c[ja] += a and c[jb] += b. Where jb is ja's upper neighbour and c + ja is
// 8-byte aligned, both go out as one float2 atomic (sm_90), which adds each
// element atomically; any other pair is two scalar adds.
__device__ __forceinline__ void add_pair(float* __restrict__ c, int32_t ja,
                                         int32_t jb, int64_t s, float a,
                                         float b) {
  if (jb == ja + 1 && ja >= 0 && jb < s &&
      (reinterpret_cast<uintptr_t>(c + ja) & 7) == 0) {
    atomicAdd(reinterpret_cast<float2*>(c + ja), make_float2(a, b));
  } else {
    add(c, ja, s, a);
    add(c, jb, s, b);
  }
}

// c[j] += a, with the lanes of the warp that hold the same j summed first
// (in lane order, so the group's sum is fixed) and added by their first
// lane. All 32 lanes call it together; a lane without an update passes
// j = -1. Each lane walks its peers above it, one shuffle a step, for
// as many steps as the warp's largest group needs: a warp without
// duplicates pays the match and one vote. (A loop of 32 shuffles over every
// lane, fully unrolled, fails in ptxas 12.9 with C7600.)
__device__ __forceinline__ void add_warp(float* __restrict__ c, int32_t j,
                                         int64_t s, float a) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int32_t key = in_range(j, s) ? j : -1;
  const unsigned peers = __match_any_sync(full, key);
  unsigned rest = key >= 0 ? peers & ~((2u << lane) - 1u) : 0u;
  float sum = a;
  while (__any_sync(full, rest != 0u)) {
    const float x = __shfl_sync(full, a, rest ? __ffs(rest) - 1 : lane);
    if (rest) {
      sum += x;
      rest &= rest - 1u;
    }
  }
  if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(c + j, sum);
}

__device__ __forceinline__ bool any_nonzero(float4 u) {
  return u.x != 0.f || u.y != 0.f || u.z != 0.f || u.w != 0.f;
}

// row[j + t] += u[t] for t = 0..3, in a row of p floats: four neighbouring
// voxels x = j .. j + 3, of which those outside [0, p) are never written.
// The row goes out as float4 atomics (sm_90) on the one or two 16-byte
// quads that hold it, zeros in the quads' other lanes (adding 0 changes no
// value, and the quads lie in the sectors the taps touch anyway); a quad
// whose values are all 0 is not sent. Where a quad would leave the row, the
// taps go out one by one. One float4 costs one L2 request, as one float
// does: a row costs one or two requests, where tap by tap it costs four.
__device__ __forceinline__ void add_row4(float* __restrict__ row, int32_t j,
                                         int32_t p, float4 u) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(row + j) & 15) >> 2);
  if (j - mis < 0 || j - mis + (mis ? 8 : 4) > p) {
    const float t[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (j + k >= 0 && j + k < p && t[k] != 0.f) atomicAdd(row + j + k, t[k]);
    return;
  }
  float4 a = u, b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mis == 1) {
    a = make_float4(0.f, u.x, u.y, u.z);
    b.x = u.w;
  } else if (mis == 2) {
    a = make_float4(0.f, 0.f, u.x, u.y);
    b = make_float4(u.z, u.w, 0.f, 0.f);
  } else if (mis == 3) {
    a = make_float4(0.f, 0.f, 0.f, u.x);
    b = make_float4(u.y, u.z, u.w, 0.f);
  }
  float4* q = reinterpret_cast<float4*>(row + j - mis);
  if (any_nonzero(a)) atomicAdd(q, a);
  if (any_nonzero(b)) atomicAdd(q + 1, b);
}

// row[j] += a and row[j + 1] += b, in a row of p floats: two neighbouring
// voxels x = j, j + 1, of which one outside [0, p) is never written. Where
// both lie in one 16-byte quad inside the row they go out as that quad's
// float4 atomic (sm_90), zeros in its other two lanes; where the pair
// straddles two quads, or a quad would leave the row, as two scalar adds.
// The quad is found from the address, not from j: rows need not start on a
// 16-byte boundary.
__device__ __forceinline__ void add_row2(float* __restrict__ row, int32_t j,
                                         int32_t p, float a, float b) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(row + j) & 15) >> 2);
  if (mis < 3 && j - mis >= 0 && j - mis + 4 <= p) {
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mis == 0) {
      u.x = a;
      u.y = b;
    } else if (mis == 1) {
      u.y = a;
      u.z = b;
    } else {
      u.z = a;
      u.w = b;
    }
    atomicAdd(reinterpret_cast<float4*>(row + j - mis), u);
    return;
  }
  if (j >= 0 && j < p) atomicAdd(row + j, a);
  if (j + 1 >= 0 && j + 1 < p) atomicAdd(row + j + 1, b);
}

// Channel-per-block-row grids: the pointer of channel ch.
template <typename T>
__device__ __forceinline__ T* pick(int ch, T* p0, T* p1, T* p2) {
  return ch == 0 ? p0 : (ch == 1 ? p1 : p2);
}

}  // namespace xm
