// Device code shared by the scatter kernels: the range-checked float atomic,
// the 8-byte vector atomic for two neighbouring voxels, the warp-aggregated
// add and the channel selection of a channel-per-block-row grid.
//
// All of it serves one fact of the card: a float atomic resolves in L2 on a
// 32-byte sector, a warp's atomic costs one L2 request per sector its lanes
// touch, and a sector that is not resident is read from device memory and
// later written back. What a scatter can save is sector requests, not
// arithmetic: walk one accumulator at a time (`pick` with the channel in
// blockIdx.y, which the card schedules after all of blockIdx.x), put two
// taps that are x-neighbours into one 8-byte atomic (`add_pair`), and sum
// the updates a warp holds for one voxel before they leave the SM
// (`add_warp`).
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

// Channel-per-block-row grids: the pointer of channel ch.
template <typename T>
__device__ __forceinline__ T* pick(int ch, T* p0, T* p1, T* p2) {
  return ch == 0 ? p0 : (ch == 1 ? p1 : p2);
}

}  // namespace xm
