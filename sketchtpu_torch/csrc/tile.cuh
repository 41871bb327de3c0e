// Shared pieces of the samebits-based kernels (samebits.cu, coreacc.cu,
// knn_scan.cu).
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

// --- the two-stage cp.async ring of the samebits-based kernels ---
//
// A 256-thread block stages RING_G chunks of two 64-row operands per stage
// into a ring of RING_STAGES stages with 8-byte cp.async, transposed to
// [plane][row] (row pitch RING_LDS words), zero-filled past an operand's
// last row. The kernel waits for stage s, passes one barrier, starts the
// copies of stage s + 1 and consumes stage s: one barrier per RING_G chunks
// with the next stage in flight.
constexpr int RING_ROWS = 64;
constexpr int RING_LDS = RING_ROWS + 1;  // +1: no store clashes
constexpr int RING_G = 2;                // chunks per stage
constexpr int RING_STAGES = 2;
constexpr int RING_CHUNK = BBITS * RING_LDS;  // words of one staged chunk
constexpr int RING_OPERAND = RING_STAGES * RING_G * RING_CHUNK;

__device__ __forceinline__ void cp_async8(u64* dst, const u64* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Staging role of a thread: warps 0-3 copy the first operand's rows, warps
// 4-7 the second's; lane < 28 copies plane lane % 14 of rows row, row + 2,
// ..., row + 14 of its warp's 16 rows.
struct RingRole {
  bool stager, second;
  int row, plane;
};

__device__ __forceinline__ RingRole ring_role(int tid) {
  const int warp = tid / 32, lane = tid % 32;
  return {lane < 2 * BBITS, warp >= 4, (warp & 3) * 16 + lane / BBITS,
          lane % BBITS};
}

// The slot of a thread's first word in stage buffer `buf`, chunk g, of an
// operand's ring.
__device__ __forceinline__ u64* ring_slot(u64* operand, const RingRole& role,
                                          int buf, int g) {
  return operand + ((buf * RING_G + g) * BBITS + role.plane) * RING_LDS +
         role.row;
}

// A thread's COPIES copies of one chunk, rows row, row + 2, ... (eight for
// ring_role's 16 rows a warp): src points at its plane word of its first
// row, rows_left counts the operand's rows from that row on; a row past
// them is zero-filled (the copy then reads nothing, from `safe`).
template <int COPIES = 8>
__device__ __forceinline__ void ring_copy(u64* dst, const u64* src,
                                          long long ld, int rows_left,
                                          const u64* safe) {
#pragma unroll
  for (int it = 0; it < COPIES; ++it) {
    const bool ok = 2 * it < rows_left;
    cp_async8(dst + 2 * it, ok ? src + 2 * it * ld : safe, ok);
  }
}

// Self-dense triangle skip: a tile whose last column is at or left of its
// first global row holds no pair with column > row, the only pairs the
// upper-triangle consumers read.
__device__ __forceinline__ bool tile_below_diagonal(int i0, int j0, int tj,
                                                    int nb, long long row0) {
  const long long last_col = (long long)min(j0 + tj, nb) - 1;
  return last_col <= row0 + i0;
}

// The partial samebits a words split's finish sums (samebits_finish,
// coreacc_chain): 1 to MAX_WORDS_SLOTS int32 arrays of one shape, their
// pointers passed by value (dist/samebits_kernels.py's MAX_WORDS_SLOTS).
constexpr int MAX_WORDS_SLOTS = 8;

struct WordsParts {
  const int* p[MAX_WORDS_SLOTS];
  int n;
};

}  // namespace stpu
