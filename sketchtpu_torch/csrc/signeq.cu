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
// count / any / all. Bound: the index's bytes, read once per query group
// (0.046 ms for 8 queries x 661,000 rows at S = 100 on an H100), and the
// compares past ~16 queries. Design, for Hopper:
// - A block holds a group of QR queries (1, 2, 4, 8 or 16, the least
//   that covers nq, fewer where S leaves no shared memory for them) in
//   shared memory for the whole launch, already in the compare's form.
//   grid.x runs over the query groups, grid.y over equal row ranges of
//   the index, so the groups' blocks of one range are neighbours in
//   launch order and the rows they share come from L2; a block walks its
//   range in tiles of 1024 rows.
// - Index rows stream once per query group through a two-stage ring of
//   8-byte cp.async copies (4-byte where the row stride or base is odd),
//   QCW words of a tile a stage, into a [row][QLD] layout that keeps the
//   8-byte loads of 32 consecutive rows free of bank conflicts. The row
//   stride is an argument.
// - Each thread owns 4 rows of a tile (lanes on consecutive rows) and QR x
//   4 accumulators; a query word is a broadcast load. Results are stored
//   along the index axis, coalesced across the warp.
// - The compares, with the query word negated per half (neg_halves; the
//   odd-S pad half staged as 1, the matrix's pad half being 0):
//   any:   acc = min_u16x2(nq + m, acc), one DPX VIADDMNMX a word; a pair
//          shares a sign where a half of acc is 0 (pair_count's compare).
//   count: acc += min_u16x2(nq + m, 1) per word, two words to an IADD3:
//          1.5 operations a word; each half of acc counts the unequal
//          halves, and count = 2 words - both.
//   all:   acc |= q ^ m, one LOP3 a word (the query as stored, its pad
//          half 0); all = (acc == 0).
//   The zero-filled word past an odd chunk is staged as a word that never
//   matches (any) or always does (count, all).
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

__device__ __forceinline__ void cp_async4(unsigned* dst, const unsigned* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(unsigned* dst, const unsigned* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

// Writes a zero word to dst without reading src.
__device__ __forceinline__ void cp_async_zero4(unsigned* dst,
                                               const unsigned* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, 0;\n" ::"r"(s),
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

// The row operand as the DPX compare takes it: negated per half, and the
// pad half of an odd S's last word (0 in the matrix) set to 1, so that its
// sum with the other operand's pad (0) is never 0.
__device__ __forceinline__ unsigned row_word(unsigned x, bool pad) {
  const unsigned v = neg_halves(x);
  return pad ? (v & 0xFFFFu) | 0x10000u : v;
}

// --- count / any / all -------------------------------------------------------

constexpr int QNT = 256;           // threads a block
constexpr int QSTAGES = 2;
constexpr int QSMEM2 = 113 * 1024; // a block's shared memory, two an SM

enum Mode { COUNT = 0, ANY = 1, ALL = 2 };

__device__ __forceinline__ void cp_async_zero8(unsigned* dst,
                                               const unsigned* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, 0;\n" ::"r"(s),
               "l"(src));
}

// Query word w (< qp, the words rounded up to 4) of query row x's packed
// words as the compare of MODE takes it.
template <int MODE>
__device__ __forceinline__ unsigned query_word(const unsigned* x, int w,
                                               int words, int odd) {
  if (w >= words) return MODE == ANY ? 0x00010001u : 0u;  // never / always
  const unsigned v = x[w];
  const bool pad = odd && w == words - 1;
  if (MODE == ALL) return pad ? v & 0xFFFFu : v;
  return row_word(v, pad);
}

template <int MODE>
__device__ __forceinline__ unsigned query_init() {
  return MODE == ANY ? 0xFFFFFFFFu : 0u;
}

// Four words of one (query, row) pair.
template <int MODE>
__device__ __forceinline__ void query_step(unsigned& acc, uint4 q, uint4 m) {
  if (MODE == ANY) {
    acc = __viaddmin_u16x2(q.x, m.x, acc);
    acc = __viaddmin_u16x2(q.y, m.y, acc);
    acc = __viaddmin_u16x2(q.z, m.z, acc);
    acc = __viaddmin_u16x2(q.w, m.w, acc);
  } else if (MODE == COUNT) {
    acc += __viaddmin_u16x2(q.x, m.x, 0x00010001u) +
           __viaddmin_u16x2(q.y, m.y, 0x00010001u);
    acc += __viaddmin_u16x2(q.z, m.z, 0x00010001u) +
           __viaddmin_u16x2(q.w, m.w, 0x00010001u);
  } else {
    acc |= (q.x ^ m.x) | (q.y ^ m.y);
    acc |= (q.z ^ m.z) | (q.w ^ m.w);
  }
}

// Index rows a thread: one for up to 8 queries a block (the launch
// streams: a stage holds whole rows where they fit), four for 16 (the
// compares bound it: a query word loaded from shared memory serves four
// rows).
template <int QR>
__host__ __device__ constexpr int rows_a_thread() {
  return QR >= 16 ? 4 : 1;
}

// out is (nq, n) int32 (count) or u8. The block's queries are rows
// [blockIdx.x * QR, + QR) of q, its index rows the blockIdx.y-th of
// gridDim.y equal ranges of [0, n), walked in tiles of QTR rows (lane l
// of warp v owns rows v * 32 RPT + l + 32 i). A stage holds cw words (a
// multiple of 4; the last chunk may hold fewer) of a tile's rows at a
// pitch of ld words (ld / 4 odd), nc chunks a tile.
template <int MODE, int QR>
__global__ void __launch_bounds__(QNT, 2)
    signeq_kernel(const unsigned* __restrict__ q, long long ldq, int nq,
                  const unsigned* __restrict__ m, long long ldm, int n,
                  int words, int odd, int qp, int cw, int nc, int ld,
                  int vec8, void* __restrict__ out) {
  constexpr int RPT = rows_a_thread<QR>(), QTR = QNT * RPT;
  extern __shared__ __align__(16) unsigned qsmem[];
  unsigned* qs = qsmem;                // [QR][qp]
  unsigned* ring = qsmem + QR * qp;    // QSTAGES x [QTR][ld]
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QR, qn = min(QR, nq - q0);
  const int r_lo = (int)((long long)n * blockIdx.y / gridDim.y);
  const int r_hi = (int)((long long)n * (blockIdx.y + 1) / gridDim.y);
  const int nst = (r_hi - r_lo + QTR - 1) / QTR * nc;  // (tile, chunk)s
  for (int e = tid; e < QR * qp; e += QNT) {
    const int qi = e / qp, w = e - qi * qp;
    qs[e] = qi < qn ? query_word<MODE>(q + (q0 + qi) * ldq, w, words, odd)
                    : 0u;  // a pad query: its results are not stored
  }

  int pf_t0 = r_lo, pf_c = 0;  // the next stage to prefetch
  // Copies the stage's rows as word pairs, consecutive pairs on
  // consecutive threads (whole rows are one contiguous run when ldm ==
  // words), zero-filling each row up to a multiple of 4 words.
  auto prefetch = [&](int s) {
    if (s < nst) {
      const int rows = min(QTR, r_hi - pf_t0), w0 = pf_c * cw;
      const int cwc = min(cw, words - w0);
      const int ppr = ((cwc + 3) >> 2) * 2;  // word pairs a staged row
      const int dr = QNT / ppr, dp = QNT - dr * ppr;
      unsigned* slot = ring + (s % QSTAGES) * (QTR * ld);
      const unsigned* mrow = m + (long long)pf_t0 * ldm + w0;
      int r = tid / ppr, p = tid - r * ppr;
      for (; r < rows; r += dr) {
        const int w = 2 * p;
        const unsigned* src = mrow + r * ldm + w;
        unsigned* dst = slot + r * ld + w;
        if (w + 1 < cwc) {
          if (vec8) {
            cp_async8(dst, src);
          } else {
            cp_async4(dst, src);
            cp_async4(dst + 1, src + 1);
          }
        } else if (w < cwc) {
          cp_async4(dst, src);
          cp_async_zero4(dst + 1, src);
        } else {
          cp_async_zero8(dst, mrow);
        }
        p += dp;
        if (p >= ppr) {
          p -= ppr;
          ++r;
        }
      }
      if (++pf_c == nc) {
        pf_c = 0;
        pf_t0 += QTR;
      }
    }
    cp_async_commit();
  };
  prefetch(0);

  const int rb = (tid >> 5) * (32 * RPT) + (tid & 31);  // first row, tile
  unsigned acc[QR][RPT];
  int t0 = r_lo, c = 0;  // the stage being compared
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<0>();  // this thread's copies of stage s have landed
    __syncthreads();     // everyone's have, and stage s - 1 is done with
    prefetch(s + 1);     // into stage s - 1's slot
    const unsigned* row = ring + (s % QSTAGES) * (QTR * ld) + rb * ld;
    const int w0 = c * cw, gc = (min(cw, words - w0) + 3) >> 2;
    if (c == 0) {
#pragma unroll
      for (int qi = 0; qi < QR; ++qi)
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[qi][i] = query_init<MODE>();
    }
    const unsigned* qw = qs + w0;
    // (at 16 queries x 4 rows, two groups in flight spill past 128
    // registers)
#pragma unroll(QR >= 16 ? 1 : 2)
    for (int g = 0; g < gc; ++g) {
      uint4 mv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        mv[i] = *reinterpret_cast<const uint4*>(row + 32 * i * ld + 4 * g);
#pragma unroll
      for (int qi = 0; qi < QR; ++qi) {
        const uint4 qv =
            *reinterpret_cast<const uint4*>(qw + qi * qp + 4 * g);
#pragma unroll
        for (int i = 0; i < RPT; ++i) query_step<MODE>(acc[qi][i], qv, mv[i]);
      }
    }
    if (++c == nc) {  // the tile's last chunk: store its results
#pragma unroll
      for (int qi = 0; qi < QR; ++qi) {
        if (qi >= qn) continue;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = t0 + rb + 32 * i;
          if (r >= r_hi) continue;
          const long long o = (long long)(q0 + qi) * n + r;
          const unsigned a = acc[qi][i];
          if (MODE == COUNT) {
            static_cast<int*>(out)[o] =
                2 * words - (int)((a & 0xFFFFu) + (a >> 16));
          } else if (MODE == ANY) {
            static_cast<unsigned char*>(out)[o] = any_zero_half(a);
          } else {
            static_cast<unsigned char*>(out)[o] = a == 0u;
          }
        }
      }
      c = 0;
      t0 += QTR;
    }
  }
  cp_async_wait<0>();
}

// The launch shape of a count / any / all with qr queries a block at
// `words`: the query pitch qp, chunks of cw words (a multiple of 4,
// balanced; all words in one where they fit), nc of them, and the staged
// pitch ld (ld / 4 odd), within the shared memory of two blocks an SM
// (past that, one).
void signeq_shape(int words, int qr, int rpt, int* qp, int* cw, int* nc,
                  int* ld) {
  *qp = (words + 3) & ~3;
  const int room = (QSMEM2 - qr * *qp * 4) / (QSTAGES * QNT * rpt * 4);
  const int lmax = room < 12 ? 4 : (room - 4) / 8 * 8 + 4;
  const int n0 = (*qp + lmax - 1) / lmax;
  *cw = ((words + n0 - 1) / n0 + 3) & ~3;
  *nc = (words + *cw - 1) / *cw;
  *ld = *cw / 4 % 2 ? *cw : *cw + 4;
}

int signeq_smem(int qr, int rpt, int qp, int ld) {
  return (qr * qp + QSTAGES * QNT * rpt * ld) * (int)sizeof(unsigned);
}

template <int MODE, int QR>
int signeq_go(const unsigned* q, long long ldq, int nq, const unsigned* m,
              long long ldm, int n, int words, int odd, int row_blocks,
              void* out, cudaStream_t st, int* blocks_per_sm) {
  constexpr int RPT = rows_a_thread<QR>();
  int qp, cw, nc, ld;
  signeq_shape(words, QR, RPT, &qp, &cw, &nc, &ld);
  const int smem = signeq_smem(QR, RPT, qp, ld);
  cudaError_t err = cudaFuncSetAttribute(
      signeq_kernel<MODE, QR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_per_sm) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, signeq_kernel<MODE, QR>, QNT, smem);
    return static_cast<int>(err);
  }
  const int vec8 = ldm % 2 == 0 && reinterpret_cast<size_t>(m) % 8 == 0;
  const dim3 grid((nq + QR - 1) / QR, row_blocks);
  signeq_kernel<MODE, QR><<<grid, QNT, smem, st>>>(
      q, ldq, nq, m, ldm, n, words, odd, qp, cw, nc, ld, vec8, out);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int signeq_mode(int qr, const unsigned* q, long long ldq, int nq,
                const unsigned* m, long long ldm, int n, int words, int odd,
                int row_blocks, void* out, cudaStream_t st,
                int* blocks_per_sm) {
  switch (qr) {
    case 1:
      return signeq_go<MODE, 1>(q, ldq, nq, m, ldm, n, words, odd,
                                row_blocks, out, st, blocks_per_sm);
    case 2:
      return signeq_go<MODE, 2>(q, ldq, nq, m, ldm, n, words, odd,
                                row_blocks, out, st, blocks_per_sm);
    case 4:
      return signeq_go<MODE, 4>(q, ldq, nq, m, ldm, n, words, odd,
                                row_blocks, out, st, blocks_per_sm);
    case 8:
      return signeq_go<MODE, 8>(q, ldq, nq, m, ldm, n, words, odd,
                                row_blocks, out, st, blocks_per_sm);
    case 16:
      return signeq_go<MODE, 16>(q, ldq, nq, m, ldm, n, words, odd,
                                 row_blocks, out, st, blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int signeq_dispatch(int mode, int qr, const unsigned* q, long long ldq,
                    int nq, const unsigned* m, long long ldm, int n,
                    int words, int odd, int row_blocks, void* out,
                    cudaStream_t st, int* blocks_per_sm) {
  if (mode == COUNT) {
    return signeq_mode<COUNT>(qr, q, ldq, nq, m, ldm, n, words, odd,
                              row_blocks, out, st, blocks_per_sm);
  }
  if (mode == ANY) {
    return signeq_mode<ANY>(qr, q, ldq, nq, m, ldm, n, words, odd,
                            row_blocks, out, st, blocks_per_sm);
  }
  if (mode == ALL) {
    return signeq_mode<ALL>(qr, q, ldq, nq, m, ldm, n, words, odd,
                            row_blocks, out, st, blocks_per_sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// --- pair_count ------------------------------------------------------------

constexpr int PT = 128;                  // rows and columns of a pair tile
constexpr int PTH = 16;                  // threads along each side
constexpr int PNT = PTH * PTH;           // 256 threads, 8 x 8 pairs each
constexpr int PLD = PT + 8;              // staged pitch, words ([word][row])
constexpr int PCW = 32;                  // most words of a streamed chunk
constexpr int PSTAGES = 3;               // column chunks in flight
constexpr int PRES = 96;                 // most words of a resident row tile

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
// packed sign words a row at row strides ldq / ldm words (an odd S's pad
// half 0 in m). qr queries a block (1, 2, 4, 8 or 16); row_blocks equal
// row ranges per query group.
extern "C" int stpu_signeq(const void* q, long long ldq, int nq,
                           const void* m, long long ldm, int n, int words,
                           int nsigns, int mode, int qr, int row_blocks,
                           void* out, void* stream) {
  if (nq < 1 || n < 1 || words < 1 || words != (nsigns + 1) / 2 ||
      words >= 65536 || row_blocks < 1 || row_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return signeq_dispatch(mode, qr, static_cast<const unsigned*>(q), ldq, nq,
                         static_cast<const unsigned*>(m), ldm, n, words,
                         nsigns & 1, row_blocks, out,
                         static_cast<cudaStream_t>(stream), nullptr);
}

// Resident count / any / all blocks per SM for qr queries a block at
// `words` sign words a row, or -1 (the queries do not fit beside the
// ring).
extern "C" int stpu_signeq_blocks_per_sm(int mode, int qr, int words) {
  if (words < 1) return -1;
  int b = 0;
  const int err = signeq_dispatch(mode, qr, nullptr, 0, 1, nullptr, 0, 1,
                                  words, 0, 1, nullptr, nullptr, &b);
  return err == 0 ? b : -1;
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
