// Sign equality over the rows of the inverted index's u16 sign matrix: the
// port of the XLA programs of sketchtpu/inverted/device.py,
// _match_matrix_scan (count / any / all, inverted.rs:229-268) and
// _match_count_schedule / _match_count_strip (`precluster --count`,
// inverted.rs:271-300).
//
// - count, any, all: for queries q (nq rows) against the index m (n rows),
//   out[qi][j] = the number of bins where the two rows hold the same sign,
//   whether there is one, or whether every bin does (count == S). Only
//   real (query, row) pairs are written, so a pad row never counts as an
//   all-match.
// - pair_count: the number of pairs i < j < n with i in [lo, hi) that
//   share at least one bin, added to a 64-bit total (past 2^31 at 661k
//   samples). lo and hi are arguments, not part of the launch shape.
//
// Bound: integer issue. A pair and two bins cost XOR, IADD and LOP3 in the
// any modes and six operations in count mode (signeq.cuh); the staged
// words feed 4 x 4 pairs a thread, so shared-memory traffic is a quarter
// of a load per pair and word. Design: 64 x 64 pair tiles of 256 threads
// (the tile of K1-K3), SIG_CHUNK words of both operands staged at a time.
// In pair_count a block owns a row tile and walks the column tiles from
// its own first row on (the first is the diagonal tile, masked to i < j;
// tiles below it are never visited), in an interleaved share when a
// launch has few row tiles; each thread tallies its pairs in 32 bits (at
// most 16 a tile) and the block adds its sum to the total with one 64-bit
// atomic.
#include "signeq.cuh"

using namespace stpu;

namespace {

constexpr int TX = 16, TY = 16;
constexpr int RM = 4, RN = 4;
constexpr int TI = TY * RM, TJ = TX * RN, NT = TX * TY;

enum Mode { COUNT = 0, ANY = 1, ALL = 2 };

template <int MODE>
__global__ void __launch_bounds__(NT)
    signeq_kernel(const unsigned* __restrict__ q, long long ldq, int nq,
                  const unsigned* __restrict__ m, long long ldm, int n,
                  int words, int nsigns, void* __restrict__ out) {
  __shared__ unsigned stage[SIG_STAGE_WORDS];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  const SignOperand a{q + (long long)i0 * ldq, ldq, nq - i0};
  const SignOperand b{m + (long long)j0 * ldm, ldm, n - j0};
  unsigned acc[RM][RN];
  if (MODE == ANY) {
    sign_tile<AnyEq, RM, RN, TY, TX>(acc, a, b, words, nsigns & 1, stage, ty,
                                     tx);
  } else {
    sign_tile<CountEq, RM, RN, TY, TX>(acc, a, b, words, nsigns & 1, stage,
                                       ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gi = i0 + ty + i * TY;
    if (gi >= nq) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gj = j0 + tx + j * TX;
      if (gj >= n) continue;
      const long long o = (long long)gi * n + gj;
      if (MODE == COUNT) {
        static_cast<int*>(out)[o] = CountEq::count(acc[i][j]);
      } else if (MODE == ANY) {
        static_cast<unsigned char*>(out)[o] = AnyEq::any(acc[i][j]);
      } else {
        static_cast<unsigned char*>(out)[o] =
            CountEq::count(acc[i][j]) == nsigns;
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
    pair_count_kernel(const unsigned* __restrict__ m, long long ldm, int n,
                      int words, int nsigns, int lo, int hi, int splits,
                      unsigned long long* __restrict__ total) {
  __shared__ unsigned stage[SIG_STAGE_WORDS];
  __shared__ unsigned long long warp_sum[NT / 32];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int r0 = lo + blockIdx.x * TI;  // the row tile's first row
  const SignOperand a{m + (long long)r0 * ldm, ldm, min(hi, n) - r0};
  const int col_tiles = (n - r0 + TJ - 1) / TJ;  // columns [r0, n)
  unsigned tally = 0u;
  for (int t = blockIdx.y; t < col_tiles; t += splits) {
    const int c0 = r0 + t * TJ;
    const SignOperand b{m + (long long)c0 * ldm, ldm, n - c0};
    unsigned acc[RM][RN];
    sign_tile<AnyEq, RM, RN, TY, TX>(acc, a, b, words, nsigns & 1, stage, ty,
                                     tx);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + i * TY;  // tile-local row, global r0 + r
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = t * TJ + tx + j * TX;  // column c0 + ... = r0 + c
        tally += (r < a.rows && c > r && r0 + c < n && AnyEq::any(acc[i][j]))
                     ? 1u : 0u;
      }
    }
  }
  unsigned long long sum = tally;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
  if (threadIdx.x % 32 == 0) warp_sum[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long block = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) block += warp_sum[w];
    if (block) atomicAdd(total, block);
  }
}

}  // namespace

// mode 0: out (nq, n) int32 equal-bin counts; 1: (nq, n) uint8 any-equal;
// 2: (nq, n) uint8 all-equal. q and m hold `words` = ceil(nsigns / 2)
// packed sign words a row at row strides ldq / ldm words.
extern "C" int stpu_signeq(const void* q, long long ldq, int nq,
                           const void* m, long long ldm, int n, int words,
                           int nsigns, int mode, void* out, void* stream) {
  if (nq < 1 || n < 1 || words < 1 || words != (nsigns + 1) / 2 ||
      words >= 65536 || (nq + TI - 1) / TI > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + TJ - 1) / TJ, (nq + TI - 1) / TI);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* pq = static_cast<const unsigned*>(q);
  const unsigned* pm = static_cast<const unsigned*>(m);
  if (mode == COUNT) {
    signeq_kernel<COUNT><<<grid, NT, 0, st>>>(pq, ldq, nq, pm, ldm, n, words,
                                              nsigns, out);
  } else if (mode == ANY) {
    signeq_kernel<ANY><<<grid, NT, 0, st>>>(pq, ldq, nq, pm, ldm, n, words,
                                            nsigns, out);
  } else if (mode == ALL) {
    signeq_kernel<ALL><<<grid, NT, 0, st>>>(pq, ldq, nq, pm, ldm, n, words,
                                            nsigns, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Adds to *total (u64 on the card) the pairs i < j < n, lo <= i < hi, that
// share a sign; `splits` blocks share a row tile's column tiles.
extern "C" int stpu_pair_count(const void* m, long long ldm, int n, int words,
                               int nsigns, int lo, int hi, int splits,
                               void* total, void* stream) {
  if (words < 1 || words != (nsigns + 1) / 2 || lo < 0 || hi > n ||
      splits < 1 || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hi <= lo) return 0;
  const dim3 grid((hi - lo + TI - 1) / TI, splits);
  pair_count_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(m), ldm, n, words, nsigns, lo, hi, splits,
      static_cast<unsigned long long*>(total));
  return static_cast<int>(cudaGetLastError());
}

// Resident pair_count blocks per SM, or -1.
extern "C" int stpu_pair_count_blocks_per_sm() {
  int b = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b, pair_count_kernel, NT, 0);
  return err == cudaSuccess ? b : -1;
}
