// Shared pieces of the two samebits-based kernels (samebits.cu, coreacc.cu).
//
// Sketch words arrive in the .skd order: per row, per 64-bin chunk, BBITS
// u64 bit-planes ([row][chunk][plane], with a caller-given row stride so a
// k-plane of a [sample][k][chunk][plane] database is read in place).
// samebits(a, b) = sum over chunks of popcount(AND_p ~(a_p ^ b_p)).
#pragma once

#include <cuda_runtime.h>

namespace stpu {

constexpr int BBITS = 14;
typedef unsigned long long u64;

// Stage one chunk (BBITS plane words) of ROWS tile rows, starting at global
// row r0, into s[plane][row]. Neighbouring threads read neighbouring words
// of a row (coalesced); the transposed store lets the compute loop read a
// plane of neighbouring rows. Rows past nrows stage as zero (their results
// are never written).
template <int ROWS, int LD>
__device__ __forceinline__ void stage_chunk(u64 (*s)[LD],
                                            const u64* __restrict__ src,
                                            long long ld, long long off,
                                            int r0, int nrows) {
  for (int e = threadIdx.x; e < ROWS * BBITS; e += blockDim.x) {
    const int r = e / BBITS;
    const int p = e - r * BBITS;
    const int g = r0 + r;
    s[p][r] = g < nrows ? src[(long long)g * ld + off + p] : 0ull;
  }
}

// One chunk of the samebits count for the thread's RM x RN pairs: rows
// ty + i*TY of sa, columns tx + j*TX of sb.
template <int RM, int RN, int TY, int TX, int LDA, int LDB>
__device__ __forceinline__ void samebits_chunk(int (&cnt)[RM][RN],
                                               const u64 (*sa)[LDA],
                                               const u64 (*sb)[LDB], int ty,
                                               int tx) {
  u64 acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = ~0ull;
#pragma unroll
  for (int p = 0; p < BBITS; ++p) {
    u64 na[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) na[i] = ~sa[p][ty + i * TY];
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = sb[p][tx + j * TX];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] &= na[i] ^ bv[j];
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) cnt[i][j] += __popcll(acc[i][j]);
}

// Self-dense triangle skip: a tile whose last column is at or left of its
// first global row holds no pair with column > row, the only pairs the
// upper-triangle consumers read.
__device__ __forceinline__ bool tile_below_diagonal(int i0, int j0, int tj,
                                                    int nb, long long row0) {
  const long long last_col = (long long)min(j0 + tj, nb) - 1;
  return last_col <= row0 + i0;
}

}  // namespace stpu
