// The split rotation, Mersenne-61 sign, bin division and minimum shared by
// the rolling hash kernels: nthash_bin.cu (DNA) and aahash_bin.cu (amino
// acids).
#pragma once

#include <cuda_runtime.h>

namespace stpu {

typedef unsigned long long u64;
constexpr u64 M61 = (1ull << 61) - 1;
constexpr u64 M33 = (1ull << 33) - 1;
constexpr u64 M31 = (1ull << 31) - 1;

// One step of the split rotation: rotate left by one, then swap bits 0 and
// 33 (the bit that left the high part and the one that left the low part).
__device__ __forceinline__ u64 srol1(u64 x) {
  const u64 y = (x << 1) | (x >> 63);
  const u64 t = (y ^ (y >> 33)) & 1ull;
  return y ^ (t | (t << 33));
}

// srol applied k times: r33 = k % 33, r31 = k % 31.
__device__ __forceinline__ u64 srolk(u64 x, int r33, int r31) {
  u64 lo = x & M33, hi = x >> 33;
  lo = ((lo << r33) | (lo >> (33 - r33))) & M33;
  hi = ((hi << r31) | (hi >> (31 - r31))) & M31;
  return (hi << 33) | lo;
}

// floor(x / d) for x < 2^61 as (x * magic) >> (64 + shift) (the proof is
// at stpu_magic_div in nthash_bin.cu).
__device__ __forceinline__ u64 magic_div(u64 x, u64 magic, int shift) {
  return __umul64hi(x, magic) >> shift;
}

// A plain L2 read of the slot skips the atomic for a value that cannot
// lower it.
__device__ __forceinline__ void global_min(u64* slot, u64 x) {
  if (x < __ldcg(slot)) atomicMin(slot, x);
}

}  // namespace stpu
