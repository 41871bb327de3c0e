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
// count / any / all. Bound: integer issue. A pair and two bins cost XOR,
// IADD and LOP3 in the any modes and six operations in count mode
// (signeq.cuh); the staged words feed 4 x 4 pairs a thread. Design: 64 x
// 64 pair tiles of 256 threads (the tile of K1-K3), SIG_CHUNK words of
// both operands staged at a time.
//
// pair_count. Bound: integer issue, one operation per pair and word.
// Design, for Hopper:
// - The compare is one DPX instruction a word (VIADDMNMX.U16x2):
//   acc = min_u16x2(na + b, acc), with na the row word negated per half.
//   A half of na + b is 0 exactly where the two signs are equal, and a
//   half of acc stays 0 once it is 0, so a pair shares a sign when either
//   half of acc is 0. The row tile is negated once as it is staged (the
//   column tiles go untouched from device memory to shared memory); the
//   pad half of an odd S's last word is staged as 1 in the row operand
//   and is 0 in the column's, so it never sums to 0.
// - The block's 128-row tile stays resident in shared memory for its whole
//   walk over column tiles (up to PRES words a row; past that, as at
//   S = 1000, a ring stage carries the row chunk too). Column tiles stream
//   through a three-stage ring of 4-byte cp.async copies with one barrier
//   a stage, so a chunk's loads overlap the previous chunk's compares.
//   Chunks are balanced (S = 100: two of 25 words).
// - 8 x 8 pairs a thread (128 x 128 a block of 256 threads) from four
//   LDS.128 a word: 64 compares for 4 shared loads.
// - A block owns a row tile and walks the column tiles from its own first
//   row on (the first is the diagonal tile, masked to i < j; tiles below
//   it are never visited), in an interleaved share when a launch has few
//   row tiles; each thread tallies its pairs in 32 bits (at most 64 a
//   tile, and at most 2^31 / 128 tiles) and the block adds its sum to the
//   total with one 64-bit atomic.
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

// --- pair_count ------------------------------------------------------------

constexpr int PT = 128;                  // rows and columns of a pair tile
constexpr int PTH = 16;                  // threads along each side
constexpr int PNT = PTH * PTH;           // 256 threads, 8 x 8 pairs each
constexpr int PLD = PT + 8;              // staged pitch, words ([word][row])
constexpr int PCW = 32;                  // most words of a streamed chunk
constexpr int PSTAGES = 3;               // column chunks in flight
constexpr int PRES = 96;                 // most words of a resident row tile

__device__ __forceinline__ void cp_async4(unsigned* dst, const unsigned* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Per-half two's-complement negation: half h of neg_halves(a) + b (u16
// adds, no carry between the halves) is 0 exactly where the halves of a
// and b are equal.
__device__ __forceinline__ unsigned neg_halves(unsigned x) {
  return ((0u - x) & 0xFFFFu) | ((0u - (x & 0xFFFF0000u)) & 0xFFFF0000u);
}

// A pair shares a sign when either half of its running minimum is 0.
__device__ __forceinline__ unsigned any_zero_half(unsigned acc) {
  return ((acc & 0xFFFFu) == 0u) | (acc < 0x10000u);
}

// The (rows, words) element walk of a staged chunk: a warp covers 8 rows
// x 4 words, so each row is read 16 bytes at a time and the transposed
// stores (pitch PLD = 8 mod 32 words) hit 32 distinct banks.
template <typename F>
__device__ __forceinline__ void chunk_walk(int cw, int tid, F&& f) {
  const int quads = (cw + 3) >> 2, lane = tid & 31;
  for (int g = tid >> 5; g < (PT / 8) * quads; g += PNT / 32) {
    const int r = (g % (PT / 8)) * 8 + (lane >> 2);
    const int w = (g / (PT / 8)) * 4 + (lane & 3);
    if (w < cw) f(r, w);
  }
}

// Copies words [0, cw) of the first `rows` rows at src (row stride ld)
// to dst[w * PLD + r] with 4-byte cp.async; rows past `rows` are left as
// they are (their pairs are masked).
__device__ __forceinline__ void stage_async(unsigned* dst, const unsigned* src,
                                            long long ld, int rows, int cw,
                                            int tid) {
  chunk_walk(cw, tid, [&](int r, int w) {
    if (r < rows) cp_async4(dst + w * PLD + r, src + r * ld + w);
  });
}

// The row operand as the compare takes it: negated per half, and the pad
// half of an odd S's last word (0 in the matrix) set to 1, so that its
// sum with the column's pad (0) is never 0.
__device__ __forceinline__ unsigned row_word(unsigned x, bool pad) {
  const unsigned v = neg_halves(x);
  return pad ? (v & 0xFFFFu) | 0x10000u : v;
}

// Each thread of a 16 x 16 grid holds 8 x 8 pairs: rows 4 ty + i and
// 64 + 4 ty + i (i < 4) of the tile, columns 4 tx + j and 64 + 4 tx + j.
__device__ __forceinline__ int pair_lane(int t, int i) {
  return (i >> 2) * (PT / 2) + 4 * t + (i & 3);
}

// RESIDENT: the row tile (all words, negated) stays in shared memory for
// the block's whole walk and a ring stage holds one column chunk. Else a
// stage holds the row chunk too, negated in place once it has landed.
template <bool RESIDENT>
__global__ void __launch_bounds__(PNT, 2)
    pair_count_kernel(const unsigned* __restrict__ m, long long ldm, int n,
                      int words, int odd, int lo, int hi, int splits, int cw,
                      int nc, unsigned long long* __restrict__ total) {
  extern __shared__ __align__(16) unsigned psmem[];
  __shared__ unsigned long long warp_sum[PNT / 32];
  const int tid = threadIdx.x, tx = tid % PTH, ty = tid / PTH;
  const int r0 = lo + blockIdx.x * PT;  // the row tile's first row
  const int arows = min(hi, n) - r0;
  const int col_tiles = (n - r0 + PT - 1) / PT;  // columns [r0, n)
  const int by = blockIdx.y;
  const int ntiles = by < col_tiles ? (col_tiles - 1 - by) / splits + 1 : 0;
  const int nst = ntiles * nc;  // ring stages: (tile, word chunk)
  const int stage_words = (RESIDENT ? 1 : 2) * cw * PLD;
  unsigned* rowt = psmem;  // RESIDENT: [words][PLD]
  unsigned* ring = psmem + (RESIDENT ? words * PLD : 0);
  const unsigned* mrow = m + (long long)r0 * ldm;

  if (RESIDENT) {
    chunk_walk(words, tid, [&](int r, int w) {
      const unsigned x = r < arows ? mrow[r * ldm + w] : 0u;
      rowt[w * PLD + r] = row_word(x, odd && w == words - 1);
    });
  }
  auto prefetch = [&](int s) {  // stage s's copies into its ring slot
    if (s < nst) {
      const int t = by + (s / nc) * splits, c = s % nc;
      const int c0 = r0 + t * PT, w0 = c * cw, cwc = min(cw, words - w0);
      unsigned* slot = ring + (s % PSTAGES) * stage_words;
      if (!RESIDENT) stage_async(slot, mrow + w0, ldm, arows, cwc, tid);
      stage_async(slot + (RESIDENT ? 0 : cw * PLD),
                  m + (long long)c0 * ldm + w0, ldm, n - c0, cwc, tid);
    }
    cp_async_commit();
  };
  prefetch(0);
  prefetch(1);

  unsigned acc[8][8];
  unsigned tally = 0u;
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<1>();  // this thread's copies of stage s have landed
    __syncthreads();     // everyone's have, and stage s - 1 is done with
    prefetch(s + 2);     // into stage s - 1's slot
    const int t = by + (s / nc) * splits, c = s % nc;
    const int w0 = c * cw, cwc = min(cw, words - w0);
    unsigned* slot = ring + (s % PSTAGES) * stage_words;
    const unsigned* ra = RESIDENT ? rowt + w0 * PLD : slot;
    const unsigned* cb = RESIDENT ? slot : slot + cw * PLD;
    if (!RESIDENT) {  // negate the landed row chunk in place
      chunk_walk(cwc, tid, [&](int r, int w) {
        slot[w * PLD + r] = row_word(slot[w * PLD + r],
                                     odd && w0 + w == words - 1);
      });
      __syncthreads();
    }
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0xFFFFFFFFu;
    }
    for (int w = 0; w < cwc; ++w) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(ra + w * PLD + 4 * ty);
      const uint4 a1 =
          *reinterpret_cast<const uint4*>(ra + w * PLD + PT / 2 + 4 * ty);
      const uint4 b0 = *reinterpret_cast<const uint4*>(cb + w * PLD + 4 * tx);
      const uint4 b1 =
          *reinterpret_cast<const uint4*>(cb + w * PLD + PT / 2 + 4 * tx);
      const unsigned av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const unsigned bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __viaddmin_u16x2(av[i], bv[j], acc[i][j]);
    }
    if (c == nc - 1) {  // the tile's last chunk: count its pairs
      const int cbase = t * PT;  // column r0 + cbase + ...
      if (t > 0 && arows >= PT && r0 + cbase + PT <= n) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) tally += any_zero_half(acc[i][j]);
      } else {  // the diagonal tile (i < j) or a ragged edge
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = pair_lane(ty, i);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int cc = cbase + pair_lane(tx, j);
            tally += (r < arows && cc > r && r0 + cc < n)
                         ? any_zero_half(acc[i][j]) : 0u;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  unsigned long long sum = tally;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
  if (tid % 32 == 0) warp_sum[tid / 32] = sum;
  __syncthreads();
  if (tid == 0) {
    unsigned long long block = 0;
#pragma unroll
    for (int w = 0; w < PNT / 32; ++w) block += warp_sum[w];
    if (block) atomicAdd(total, block);
  }
}

// The compare's issue rate alone: every thread keeps 8 x 8 accumulators
// over 8 + 8 register words, as pair_count does, and adds one to each
// row word a round (the same 8 IADDs a round in every mode, so that no
// operand is loop-invariant). MODE 0: XOR / IADD / LOP3 (AnyEq); 1: one
// VIADDMNMX.U16x2 (pair_count's compare).
template <int MODE>
__global__ void __launch_bounds__(PNT, 2)
    compare_rate_kernel(unsigned seed, int rounds, unsigned* __restrict__ out) {
  const unsigned id = blockIdx.x * PNT + threadIdx.x;
  unsigned av[8], bv[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    av[i] = (seed ^ id) * 0x9E3779B9u + i * 0x85EBCA6Bu;
    bv[i] = (seed + id) * 0xC2B2AE35u + i * 0x27D4EB2Fu;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = MODE ? 0xFFFFFFFFu : 0u;
  for (int t = 0; t < rounds; ++t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      av[i] += 0x00010001u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (MODE) {
          acc[i][j] = __viaddmin_u16x2(av[i], bv[j], acc[i][j]);
        } else {
          AnyEq::step(acc[i][j], av[i], bv[j]);
        }
      }
    }
  }
  unsigned x = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) x ^= acc[i][j];
  out[id] = x;
}

template <bool RESIDENT>
int pair_count_smem(int words, int cw) {
  return ((RESIDENT ? words : 0) + PSTAGES * (RESIDENT ? 1 : 2) * cw) * PLD *
         (int)sizeof(unsigned);
}

// The launch shape of a pair_count at `words`: word chunks of cw words,
// nc of them, balanced so that no chunk is a short tail.
void pair_count_shape(int words, int* cw, int* nc, bool* resident) {
  *nc = (words + PCW - 1) / PCW;
  *cw = (words + *nc - 1) / *nc;
  *resident = words <= PRES;
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
  int cw, nc;
  bool resident;
  pair_count_shape(words, &cw, &nc, &resident);
  const dim3 grid((hi - lo + PT - 1) / PT, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* pm = static_cast<const unsigned*>(m);
  unsigned long long* pt = static_cast<unsigned long long*>(total);
  const int odd = nsigns & 1;
  if (resident) {
    const int smem = pair_count_smem<true>(words, cw);
    cudaFuncSetAttribute(pair_count_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    pair_count_kernel<true><<<grid, PNT, smem, st>>>(
        pm, ldm, n, words, odd, lo, hi, splits, cw, nc, pt);
  } else {
    const int smem = pair_count_smem<false>(words, cw);
    cudaFuncSetAttribute(pair_count_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    pair_count_kernel<false><<<grid, PNT, smem, st>>>(
        pm, ldm, n, words, odd, lo, hi, splits, cw, nc, pt);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident pair_count blocks per SM at `words` sign words a row, or -1.
extern "C" int stpu_pair_count_blocks_per_sm(int words) {
  if (words < 1) return -1;
  int cw, nc, b = 0;
  bool resident;
  pair_count_shape(words, &cw, &nc, &resident);
  cudaError_t err;
  if (resident) {
    const int smem = pair_count_smem<true>(words, cw);
    cudaFuncSetAttribute(pair_count_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, pair_count_kernel<true>, PNT, smem);
  } else {
    const int smem = pair_count_smem<false>(words, cw);
    cudaFuncSetAttribute(pair_count_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, pair_count_kernel<false>, PNT, smem);
  }
  return err == cudaSuccess ? b : -1;
}

// The compare microbenchmark: `blocks` blocks of 256 threads, `rounds`
// rounds of 64 word compares a thread (mode 0: XOR / IADD / LOP3, 1: one
// VIADDMNMX), one word a thread into out.
extern "C" int stpu_compare_rate(int mode, int blocks, int rounds, void* out,
                                 void* stream) {
  if (blocks < 1 || rounds < 1 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* po = static_cast<unsigned*>(out);
  if (mode == 0) {
    compare_rate_kernel<0><<<blocks, PNT, 0, st>>>(0x5EEDu, rounds, po);
  } else {
    compare_rate_kernel<1><<<blocks, PNT, 0, st>>>(0x5EEDu, rounds, po);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident compare_rate blocks per SM, or -1.
extern "C" int stpu_compare_rate_blocks_per_sm() {
  int b = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b, compare_rate_kernel<1>, PNT, 0);
  return err == cudaSuccess ? b : -1;
}
