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

// The inverse of srol1: swap bits 0 and 33, then rotate right by one.
__device__ __forceinline__ u64 sror1(u64 x) {
  const u64 t = (x ^ (x >> 33)) & 1ull;
  const u64 y = x ^ (t | (t << 33));
  return (y >> 1) | (y << 63);
}

// ntHash (nthash_bin.cu). A window's first hashes in Horner form, one base
// b (code | break << 2) at a time: fwd <- srol(fwd) ^ SEED[c],
// v <- sror(v ^ RC[c]), rev = srol^k(v) once the window is k bases long.
__device__ __forceinline__ void nt_extend(u64& fh, u64& v, unsigned b,
                                          const u64* seed, const u64* rcs) {
  fh = srol1(fh) ^ seed[b & 3u];
  v = sror1(v ^ rcs[b & 3u]);
}

// One roll at k: drop the base of code bo, take the base bi; t is k's
// table row (srol^k(SEED), srol^(k-1)(RC)).
__device__ __forceinline__ void nt_roll(u64& f, u64& r, unsigned bo,
                                        unsigned bi, const u64* t,
                                        const u64* seed, const u64* rcs) {
  f = srol1(f) ^ t[bo] ^ seed[bi & 3u];
  r = sror1(r ^ rcs[bo]) ^ t[4 + (bi & 3u)];
}

// A window's sign: its canonical hash (the smaller strand with rc) mod
// 2^61 - 1 by shift-add (signs.py).
__device__ __forceinline__ u64 nt_sign(u64 f, u64 r, int rc) {
  const u64 h = (rc && r < f) ? r : f;
  u64 x = (h & M61) + (h >> 61);
  if (x >= M61) x -= M61;
  return x;
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
