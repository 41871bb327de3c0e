// K1: exact samebits strips, the port of sketchtpu/dist/pallas_kernels.py
// samebits_strip_fused (kernel _samebits_strip_kernel).
//
// out[i][j] = sum_c popcount(AND_p ~(a[i][c][p] ^ b[j][c][p])) as int16 (the
// dense-stream strips; exact since samebits <= s64*64 <= 32767) or int32
// (the all-pairs matrix the host distance functions call). With tri, tiles
// wholly at or below the diagonal (global row = row0 + i) are written as
// zeros without computing them.
//
// Bound: integer ALU. Each pair costs s64 * BBITS * (xor + and) on 64-bit
// words plus s64 popcounts, against (na + nb) * s64 * BBITS * 8 bytes read
// per tile row/column (the column matrix of a main-path strip fits in L2).
// Design: a 64 x 64 pair tile per 256-thread block, 4 x 4 pairs per thread
// in registers, one chunk of both operands staged through shared memory at
// a time; each staged word feeds 4 pairs.
#include "tile.cuh"

using namespace stpu;

namespace {

constexpr int TX = 16, TY = 16;  // threads
constexpr int RM = 4, RN = 4;    // pairs per thread
constexpr int TI = TY * RM, TJ = TX * RN, NT = TX * TY;
constexpr int LDS_A = TI + 1, LDS_B = TJ + 1;  // +1 word: fewer bank clashes

template <typename OutT>
__global__ void __launch_bounds__(NT)
    samebits_kernel(const u64* __restrict__ a, long long lda,
                    const u64* __restrict__ b, long long ldb,
                    OutT* __restrict__ out, long long ldo, int na, int nb,
                    int s64, int tri, long long row0) {
  __shared__ u64 sa[BBITS][LDS_A];
  __shared__ u64 sb[BBITS][LDS_B];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;

  int cnt[RM][RN] = {};
  const bool skip = tri && tile_below_diagonal(i0, j0, TJ, nb, row0);
  if (!skip) {
    for (int c = 0; c < s64; ++c) {
      stage_chunk<TI, LDS_A>(sa, a, lda, (long long)c * BBITS, i0, na);
      stage_chunk<TJ, LDS_B>(sb, b, ldb, (long long)c * BBITS, j0, nb);
      __syncthreads();
      samebits_chunk<RM, RN, TY, TX, LDS_A, LDS_B>(cnt, sa, sb, ty, tx);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gi = i0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gj = j0 + tx + j * TX;
      if (gi < na && gj < nb) out[(long long)gi * ldo + gj] = (OutT)cnt[i][j];
    }
  }
}

}  // namespace

extern "C" int stpu_samebits(const void* a, long long lda, const void* b,
                             long long ldb, void* out, long long ldo, int na,
                             int nb, int s64, int out_bytes, int tri,
                             long long row0, void* stream) {
  const dim3 grid((nb + TJ - 1) / TJ, (na + TI - 1) / TI);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const u64* pa = static_cast<const u64*>(a);
  const u64* pb = static_cast<const u64*>(b);
  if (out_bytes == 2) {
    samebits_kernel<short><<<grid, NT, 0, st>>>(
        pa, lda, pb, ldb, static_cast<short*>(out), ldo, na, nb, s64, tri,
        row0);
  } else if (out_bytes == 4) {
    samebits_kernel<int><<<grid, NT, 0, st>>>(pa, lda, pb, ldb,
                                              static_cast<int*>(out), ldo, na,
                                              nb, s64, tri, row0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
