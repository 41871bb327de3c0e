// Sign equality over u16 inverted-index signs, shared by the precluster
// sign mask of K3 (knn_scan.cu) and K2's key mode (coreacc.cu); signeq.cu
// (the inverted index's queries and `precluster --count`) takes AnyEq for
// its compare microbenchmark.
//
// Signs arrive packed two to a 32-bit word (bin 2w in the low half, bin
// 2w + 1 in the high half), `words` words a row at a row stride of `ld`
// words. With an odd sign count the high half of a row's last word is
// padding, stored as 0; the column operand's copy of it is staged as
// 0xFFFF, so the pad half of a ^ b is never zero and never matches.
//
// Per word x = a ^ b, a half is zero where the two signs are equal:
// (x - 0x00010001) & ~x has bit 15 or 31 set only if some half of x is
// zero (the borrow out of a zero low half can set bit 31 of a nonzero high
// half, but only when the low half is zero), so OR-ing it over the words
// and testing 0x80008000 at the end is exact: XOR, IADD and one LOP3 per
// two bins.
#pragma once

#include <cuda_runtime.h>

namespace stpu {

constexpr int SIG_ROWS = 64;             // rows of each operand in a tile
constexpr int SIG_LDS = SIG_ROWS + 1;    // staged row pitch, in words
constexpr int SIG_CHUNK = 16;            // words of a staged chunk
constexpr int SIG_STAGE_WORDS = 2 * SIG_CHUNK * SIG_LDS;  // both operands

struct SignOperand {
  const unsigned* sig;  // the tile's first row
  long long ld;         // row stride, words
  int rows;             // real rows from the tile's first on
};

struct AnyEq {
  __device__ __forceinline__ static void step(unsigned& acc, unsigned a,
                                              unsigned b) {
    const unsigned x = a ^ b;
    acc |= (x - 0x00010001u) & ~x;
  }
  __device__ __forceinline__ static bool any(unsigned acc) {
    return (acc & 0x80008000u) != 0u;
  }
};

// Walks the `words` sign words of a 64 x 64 tile for the thread's RM x RN
// pairs (rows ty + i * TY of a, columns tx + j * TX of b), staging
// SIG_CHUNK words of both operands at a time through `stage`
// (SIG_STAGE_WORDS words of shared memory, transposed to [word][row]).
// Rows past an operand's real rows are staged as zero. Every thread of the
// 256-thread block calls it; it starts and ends with a barrier, so the
// caller may reuse `stage` around it.
template <typename Op, int RM, int RN, int TY, int TX>
__device__ __forceinline__ void sign_tile(unsigned (&acc)[RM][RN],
                                          const SignOperand& a,
                                          const SignOperand& b, int words,
                                          int odd, unsigned* stage, int ty,
                                          int tx) {
  constexpr int NT = TX * TY;
  static_assert(RM * TY == SIG_ROWS && RN * TX == SIG_ROWS,
                "a sign tile is 64 x 64 pairs");
  const int tid = ty * TX + tx;
  unsigned* sa = stage;
  unsigned* sb = stage + SIG_CHUNK * SIG_LDS;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0u;
  for (int w0 = 0; w0 < words; w0 += SIG_CHUNK) {
    const int cw = min(SIG_CHUNK, words - w0);
    __syncthreads();  // the previous chunk (or the caller) is done with it
    for (int e = tid; e < SIG_ROWS * SIG_CHUNK; e += NT) {
      const int r = e / SIG_CHUNK, w = e % SIG_CHUNK;
      unsigned va = 0u, vb = 0u;
      if (w < cw) {
        if (r < a.rows) va = a.sig[r * a.ld + w0 + w];
        if (r < b.rows) vb = b.sig[r * b.ld + w0 + w];
        if (odd && w0 + w == words - 1) vb |= 0xFFFF0000u;
      }
      sa[w * SIG_LDS + r] = va;
      sb[w * SIG_LDS + r] = vb;
    }
    __syncthreads();
    for (int w = 0; w < cw; ++w) {
      unsigned av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = sa[w * SIG_LDS + ty + i * TY];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = sb[w * SIG_LDS + tx + j * TX];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) Op::step(acc[i][j], av[i], bv[j]);
    }
  }
  __syncthreads();
}

// The precluster mask of the thread's RM x RN pairs: bit i * RN + j set
// where row ty + i * TY and column tx + j * TX share at least one sign.
template <int RM, int RN, int TY, int TX>
__device__ __forceinline__ unsigned sign_any_mask(const SignOperand& a,
                                                  const SignOperand& b,
                                                  int words, int odd,
                                                  unsigned* stage, int ty,
                                                  int tx) {
  unsigned acc[RM][RN];
  sign_tile<AnyEq, RM, RN, TY, TX>(acc, a, b, words, odd, stage, ty, tx);
  unsigned bits = 0u;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      if (AnyEq::any(acc[i][j])) bits |= 1u << (i * RN + j);
  return bits;
}

}  // namespace stpu
