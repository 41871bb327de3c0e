// K3: the kNN scan, the port of sketchtpu/dist/pallas_kernels.py
// samebits_pallas_chunked (kernel _samebits_chunked_kernel) fused with the
// key epilogue and the per-row top-k merge that the JAX scans run in XLA
// around it (dist/knn_jax.py _knn_scan_block_packed and
// _knn_scan_block_comp).
//
// Keys. For a row with global id `row` and a column with global id `col`,
// the exact samebits of the pair becomes one selection key:
// - plain mode: sb << shift | (colmask - col), as int32 (shift from
//   _pack_shift, colmask = 2^shift - 1) or int64 (shift 32);
// - completeness mode (c1 != null): the corrected f32 Jaccard, computed
//   with the JAX expression's operations in its order,
//     max(sb - expected, 0) * maxnbits / (maxnbits - expected) / maxnbits,
//   then j / (prod / (c1 + c2 - prod)) clamped at 1 where c1*c2 >= cutoff,
//   as int64 (order-preserving int32 of its bits) << 32 | (colmask - col).
// Pairs whose column is at or past the real columns or, with exclude_self,
// equals the row are invalid: -1, below every valid key (valid keys are
// >= 0). In masked mode (the inverted index's precluster, the port of
// knn_jax._knn_scan_block_packed(masked=True) and of the a_sig / b_sig
// mask of _knn_scan_block_comp_pallas) a pair whose rows share no u16
// sign of the index is invalid too: the mask is one more validity term,
// computed per 64 x 64 tile by signeq.cuh's sign_any_mask, the routine of
// the index's own queries, through SIG_STAGE_WORDS of shared memory. Since every key holds its column, keys are unique and the knn
// largest of a row are one set, ordered value descending, then column
// ascending, whatever order they were found in.
//
// Two modes share the tile walk and the key arithmetic:
// - selection (stpu_knn_select): a block owns a tile of rows and walks
//   64-column tiles of the whole column plane. Each row's running
//   selection (its knn best keys, sorted descending) and its threshold (the
//   knn-th best) stay in shared memory for the whole walk. After each tile
//   a thread compares its 16 keys with its 4 rows' thresholds and appends
//   the ones that pass to the row's candidate list; then one warp per row
//   inserts the candidates into the sorted list. A row sees about
//   knn * ln(columns / knn) passing keys in all, so only (rows, knn) keys
//   ever leave the kernel. A grid of row tiles x column splits; with more
//   than one split each writes its own (rows, knn) and a second kernel
//   merges the splits with the same insert routine.
// - tile (stpu_knn_keys): the keys of one (rows, columns) tile, written
//   out; its walk covers one column tile.
//
// Bound: integer ALU, as K1 (its 64 x 64 pair tile, 4 x 4 pairs per
// thread). Design: the (column tile, chunk) sequence is flattened and runs
// through the two-stage cp.async ring of tile.cuh, two chunks per barrier
// with the next stage in flight, across column-tile boundaries and for any
// s64; both operands are re-staged per column tile (from L2: the blocks
// resident together walk the same columns), which leaves room for two
// blocks per SM while the lists are small (at knn 50: 88 KB a block with
// int32 keys, 101 KB with int64 keys, whose candidates take two passes of
// 32 rows). A list of at most 64 keys is inserted into in registers, two
// keys a lane, with shuffles; a longer one in shared memory. The lists
// bound knn: a block keeps rows x knn keys, with 64 rows per block while
// that fits the 227 KB of shared memory, else 32 or 16 (the other rows of
// the pair tile idle); MAX_KNN = 1024 fits with 16 rows of int64 keys.
#include "signeq.cuh"
#include "tile.cuh"

using namespace stpu;

namespace {

constexpr int TX = 16, TY = 16;  // threads
constexpr int RM = 4, RN = 4;    // pairs per thread
constexpr int TI = TY * RM, TJ = TX * RN, NT = TX * TY;
constexpr int LDS = RING_LDS;
constexpr int RING_BYTES = 2 * RING_OPERAND * 8;
constexpr int MAX_KNN = 1024;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90
constexpr int MERGE_WARPS = 4;
static_assert(TI == RING_ROWS && TJ == RING_ROWS,
              "the ring stages 64 rows of each operand");

__device__ __forceinline__ int ordered_bits(float v) {
  const int b = __float_as_int(v);
  return b < 0 ? b ^ 0x7FFFFFFF : b;
}

// What a key is made of, beside the pair's samebits.
struct KeyParams {
  long long row0, col0;
  int exclude_self, shift;
  long long colmask;
  const float* c1;  // rows' completeness (tile-local index), or null
  const float* c2;  // columns' completeness (tile-local index)
  float cutoff, expected, maxnbits, denom;
  // masked mode: the rows' and columns' packed signs (tile-local index as
  // c1 / c2), words a row, row stride (words), odd sign count
  const unsigned* asig;
  const unsigned* bsig;
  int swords;
  long long sld;
  int sodd;
};

// The sign mask of the thread's pairs of the 64 x 64 tile whose rows start
// at i0 (arows real) and columns at j0 (ncols real columns in all).
__device__ __forceinline__ unsigned tile_sign_mask(const KeyParams& p, int i0,
                                                   int arows, int j0,
                                                   int ncols, unsigned* stage,
                                                   int ty, int tx) {
  const SignOperand sa{p.asig + (long long)i0 * p.sld, p.sld, arows};
  const SignOperand sb{p.bsig + (long long)j0 * p.sld, p.sld, ncols - j0};
  return sign_any_mask<RM, RN, TY, TX>(sa, sb, p.swords, p.sodd, stage, ty,
                                       tx);
}

// The key of a valid pair.
template <typename KeyT, bool COMP>
__device__ __forceinline__ KeyT pair_key(int sb, long long col, float c1v,
                                         float c2v, const KeyParams& p) {
  if (COMP) {
    const float diff = fmaxf((float)sb - p.expected, 0.f);
    float jac = (diff * p.maxnbits / p.denom) / p.maxnbits;
    const float prod = c1v * c2v;
    const float factor = prod / (c1v + c2v - prod);
    if (prod >= p.cutoff) {
      const float q = jac / factor;
      jac = q > 1.f ? 1.f : q;  // NaN-propagating min, as jnp.minimum
    }
    const unsigned long long hi =
        (unsigned long long)(long long)ordered_bits(jac) << 32;
    return (KeyT)(hi | (unsigned long long)(p.colmask - col));
  }
  return ((KeyT)sb << p.shift) | (KeyT)(p.colmask - col);
}

// Samebits of the block's rows [i0, i0 + arows) of `a` against the column
// tiles [jt0, jt1) of `b` (64 columns each, columns past ncols staged as
// zero), through the ring in sA / sB. epi(jt, cnt) runs on every thread
// when a tile's 16 counts are complete; it may hold block barriers.
template <typename Epi>
__device__ __forceinline__ void walk_tiles(u64* sA, u64* sB,
                                           const u64* __restrict__ a,
                                           long long lda, int i0, int arows,
                                           const u64* __restrict__ b,
                                           long long ldb, int ncols, int s64,
                                           int jt0, int jt1, Epi&& epi) {
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const RingRole role = ring_role(tid);
  const u64* a_src = a + (long long)(i0 + role.row) * lda + role.plane;
  const int a_left = arows - role.row;
  const int total = (jt1 - jt0) * s64;  // flattened (column tile, chunk)
  const int nstage = (total + RING_G - 1) / RING_G;
  auto load_stage = [&](int s) {
    if (!role.stager) return;
    const int buf = s % RING_STAGES;
#pragma unroll
    for (int g = 0; g < RING_G; ++g) {
      const int t = s * RING_G + g;
      if (t >= total) break;
      const int tile = t / s64;
      const long long off = (long long)(t - tile * s64) * BBITS;
      if (role.second) {
        const int r = (jt0 + tile) * TJ + role.row;
        ring_copy(ring_slot(sB, role, buf, g),
                  b + (long long)r * ldb + off + role.plane, ldb, ncols - r,
                  b);
      } else {
        ring_copy(ring_slot(sA, role, buf, g), a_src + off, lda, a_left, a);
      }
    }
  };

  load_stage(0);
  cp_async_commit();
  int cnt[RM][RN] = {};
  int c = 0, jt = jt0;  // chunk and column tile of the next chunk consumed
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s is in; everyone is done with stage s - 1
    if (s + 1 < nstage) load_stage(s + 1);
    cp_async_commit();
    const int buf = s % RING_STAGES;
#pragma unroll
    for (int g = 0; g < RING_G; ++g) {
      if (s * RING_G + g >= total) break;
      const int at = (buf * RING_G + g) * RING_CHUNK;
      samebits_chunk<RM, RN, TY, TX, LDS, LDS>(
          cnt, reinterpret_cast<const u64(*)[LDS]>(sA + at),
          reinterpret_cast<const u64(*)[LDS]>(sB + at), ty, tx);
      if (++c < s64) continue;
      epi(jt, cnt);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) cnt[i][j] = 0;
      c = 0;
      ++jt;
    }
  }
}

// --- tile mode -------------------------------------------------------------

template <typename KeyT, bool COMP, bool MASK>
__global__ void __launch_bounds__(NT, 2)
    knn_keys_kernel(const u64* __restrict__ a, long long lda,
                    const u64* __restrict__ b, long long ldb,
                    KeyT* __restrict__ out, long long ldo, int tr, int tc,
                    int ncols, int s64, const KeyParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sA = reinterpret_cast<u64*>(smem);
  u64* sB = sA + RING_OPERAND;
  unsigned* s_sig = reinterpret_cast<unsigned*>(sB + RING_OPERAND);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;

  auto write_keys = [&](int, const int (&cnt)[RM][RN]) {
    const unsigned mbits =
        MASK && j0 < ncols
            ? tile_sign_mask(p, i0, min(TI, tr - i0), j0, ncols, s_sig, ty, tx)
            : ~0u;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gi = i0 + ty + i * TY;
      if (gi >= tr) continue;
      const long long row = p.row0 + gi;
      const float c1v = COMP ? p.c1[gi] : 1.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gj = j0 + tx + j * TX;
        if (gj >= tc) continue;
        const long long col = p.col0 + gj;
        KeyT key = -1;
        if (gj < ncols && !(p.exclude_self && col == row) &&
            ((mbits >> (i * RN + j)) & 1u)) {
          key = pair_key<KeyT, COMP>(cnt[i][j], col, c1v,
                                     COMP ? p.c2[gj] : 1.f, p);
        }
        out[(long long)gi * ldo + gj] = key;
      }
    }
  };
  if (j0 < ncols) {
    walk_tiles(sA, sB, a, lda, i0, min(TI, tr - i0), b, ldb, ncols, s64,
               (int)blockIdx.x, (int)blockIdx.x + 1, write_keys);
  } else {  // a tile wholly past the real columns holds invalid keys only
    const int none[RM][RN] = {};
    write_keys(0, none);
  }
}

// --- selection mode --------------------------------------------------------

// Insert `key` (above list[knn - 1], the row's threshold) into the
// descending list of knn keys in shared memory; the last key drops out.
// All 32 lanes of the warp call it together. One pass from the last chunk
// of 32 keys down: a key above `key` stays, the first one not above it
// gives way to `key`, every later one takes its left neighbour's value; a
// chunk that holds only keys above `key` ends the pass. Returns the new
// threshold.
template <typename KeyT>
__device__ __forceinline__ KeyT list_insert(KeyT* list, int knn, KeyT key,
                                            int lane) {
  for (int base = (knn - 1) / 32 * 32; base >= 0; base -= 32) {
    const int idx = base + lane;
    const bool in = idx < knn;
    const KeyT v = in ? list[idx] : 0;
    const KeyT left = in && idx > 0 ? list[idx - 1] : 0;
    const bool stays = !in || v > key;
    if (__ballot_sync(0xFFFFFFFFu, stays) == 0xFFFFFFFFu) break;
    __syncwarp();  // every lane has read its left neighbour
    if (!stays) list[idx] = (idx == 0 || left > key) ? key : left;
  }
  __syncwarp();
  return list[knn - 1];
}

// The same insert for a list of at most 64 keys held in registers: lane l
// holds list[l] in v0 and list[32 + l] in v1 (keys past knn are -1 or the
// next best, never read). `last` is knn - 1.
template <typename KeyT>
__device__ __forceinline__ KeyT reg_insert(KeyT& v0, KeyT& v1, KeyT key,
                                           int lane, int last) {
  const KeyT left0 = __shfl_up_sync(0xFFFFFFFFu, v0, 1);
  KeyT left1 = __shfl_up_sync(0xFFFFFFFFu, v1, 1);
  const KeyT carry = __shfl_sync(0xFFFFFFFFu, v0, 31);
  if (lane == 0) left1 = carry;
  if (!(v0 > key)) v0 = (lane == 0 || left0 > key) ? key : left0;
  if (!(v1 > key)) v1 = left1 > key ? key : left1;
  return __shfl_sync(0xFFFFFFFFu, last < 32 ? v0 : v1, last & 31);
}

// Rows of a selection block's candidate buffer: 8-byte keys take the pair
// tile's rows in two passes of 32, so that two blocks fit an SM at the
// usual knn.
__host__ __device__ constexpr int cand_rows(int rows, int key_bytes) {
  return rows < TI * 4 / key_bytes ? rows : TI * 4 / key_bytes;
}

// Shared memory of a selection block of `rows` rows: the ring, then the
// lists (knn keys a row), the candidates (TJ keys a buffer row), and per
// row the threshold, the candidate count and the completeness value.
// With the sign mask, SIG_STAGE_WORDS words follow.
__host__ __device__ constexpr int select_smem(int rows, int knn,
                                              int key_bytes, bool mask) {
  return RING_BYTES +
         (rows * (knn + 1) + cand_rows(rows, key_bytes) * TJ) * key_bytes +
         rows * 8 + (mask ? SIG_STAGE_WORDS * 4 : 0);
}

template <typename KeyT, bool COMP, bool MASK>
__global__ void __launch_bounds__(NT, 2)
    knn_select_kernel(const u64* __restrict__ a, long long lda,
                      const u64* __restrict__ b, long long ldb,
                      KeyT* __restrict__ out, int tr, int ncols, int s64,
                      int knn, int rows, int row_tiles, int splits,
                      const KeyParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sA = reinterpret_cast<u64*>(smem);
  u64* sB = sA + RING_OPERAND;
  KeyT* s_list = reinterpret_cast<KeyT*>(sB + RING_OPERAND);
  KeyT* s_cand = s_list + rows * knn;
  KeyT* s_thr = s_cand + cand_rows(rows, sizeof(KeyT)) * TJ;
  int* s_cnt = reinterpret_cast<int*>(s_thr + rows);
  float* s_c1 = reinterpret_cast<float*>(s_cnt + rows);
  unsigned* s_sig = reinterpret_cast<unsigned*>(s_c1 + rows);

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int warp = tid / 32, lane = tid % 32;
  const int i0 = (blockIdx.x % row_tiles) * rows;
  const int split = blockIdx.x / row_tiles;
  const int arows = min(rows, tr - i0);
  // this split's column tiles: an even share of all of them
  const int col_tiles = (ncols + TJ - 1) / TJ;
  const int jt0 = (int)((long long)col_tiles * split / splits);
  const int jt1 = (int)((long long)col_tiles * (split + 1) / splits);

  for (int e = tid; e < rows * knn; e += NT) s_list[e] = -1;
  for (int e = tid; e < rows; e += NT) {
    s_thr[e] = -1;
    s_cnt[e] = 0;
    s_c1[e] = COMP && e < arows ? p.c1[i0 + e] : 1.f;
  }
  __syncthreads();

  constexpr int PASSES = sizeof(KeyT) / 4;  // candidate passes per tile
  constexpr int PROWS = TI / PASSES, PI = RM / PASSES;
  auto select = [&](int jt, const int (&cnt)[RM][RN]) {
    const int j0 = jt * TJ;
    const unsigned mbits =
        MASK ? tile_sign_mask(p, i0, arows, j0, ncols, s_sig, ty, tx) : ~0u;
#pragma unroll
    for (int h = 0; h < PASSES; ++h) {
      if (h * PROWS >= arows) break;  // the same for every thread
#pragma unroll
      for (int i = h * PI; i < (h + 1) * PI; ++i) {
        const int r = ty + i * TY;
        if (r >= arows) continue;
        const long long row = p.row0 + i0 + r;
        const KeyT thr = s_thr[r];
        const float c1v = s_c1[r];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int gj = j0 + tx + j * TX;
          const long long col = p.col0 + gj;
          if (gj >= ncols || (p.exclude_self && col == row) ||
              !((mbits >> (i * RN + j)) & 1u)) {
            continue;
          }
          const KeyT key = pair_key<KeyT, COMP>(cnt[i][j], col, c1v,
                                                COMP ? p.c2[gj] : 1.f, p);
          if (key > thr) {
            s_cand[(r - h * PROWS) * TJ + atomicAdd(&s_cnt[r], 1)] = key;
          }
        }
      }
      __syncthreads();
      const int rend = min(arows, (h + 1) * PROWS);
      for (int r = h * PROWS + warp; r < rend; r += NT / 32) {
        const int n = s_cnt[r];
        if (n == 0) continue;
        const KeyT* cand = s_cand + (r - h * PROWS) * TJ;
        KeyT* list = s_list + r * knn;
        KeyT thr = s_thr[r];
        if (knn <= 64) {
          KeyT v0 = lane < knn ? list[lane] : -1;
          KeyT v1 = 32 + lane < knn ? list[32 + lane] : -1;
          for (int q = 0; q < n; ++q) {
            const KeyT key = cand[q];
            if (key > thr) thr = reg_insert(v0, v1, key, lane, knn - 1);
          }
          if (lane < knn) list[lane] = v0;
          if (32 + lane < knn) list[32 + lane] = v1;
        } else {
          for (int q = 0; q < n; ++q) {
            const KeyT key = cand[q];
            if (key > thr) thr = list_insert(list, knn, key, lane);
          }
        }
        if (lane == 0) {
          s_thr[r] = thr;
          s_cnt[r] = 0;
        }
      }
      __syncthreads();
    }
  };
  walk_tiles(sA, sB, a, lda, i0, arows, b, ldb, ncols, s64, jt0, jt1, select);

  KeyT* dst = out + ((long long)split * tr + i0) * knn;
  for (int e = tid; e < arows * knn; e += NT) dst[e] = s_list[e];
}

// Merge the splits' (tr, knn) selections: one warp per row starts from
// split 0's list and inserts the other splits' keys while they pass.
template <typename KeyT>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
    knn_merge_kernel(const KeyT* __restrict__ part, KeyT* __restrict__ out,
                     int tr, int knn, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * MERGE_WARPS + warp;
  if (row >= tr) return;
  KeyT* list = reinterpret_cast<KeyT*>(smem) + warp * knn;
  for (int e = lane; e < knn; e += 32) list[e] = part[(long long)row * knn + e];
  __syncwarp();
  KeyT thr = list[knn - 1];
  for (int s = 1; s < splits; ++s) {
    const KeyT* src = part + ((long long)s * tr + row) * knn;
    for (int q = 0; q < knn; ++q) {
      const KeyT key = src[q];
      if (key <= thr) break;  // descending: the rest is lower still
      thr = list_insert(list, knn, key, lane);
    }
  }
  for (int e = lane; e < knn; e += 32) out[(long long)row * knn + e] = list[e];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// at every launch and query: the attributes belong to the current device
// only, and the caller makes the tensors' device current
template <typename KeyT, bool COMP, bool MASK>
cudaError_t configured() {
  cudaError_t e = allow_smem(knn_keys_kernel<KeyT, COMP, MASK>);
  return e != cudaSuccess ? e
                          : allow_smem(knn_select_kernel<KeyT, COMP, MASK>);
}

// Rows per selection block: the most of 64, 32, 16 whose lists fit.
int select_rows(int knn, int key_bytes, bool mask) {
  for (int rows = TI; rows >= 16; rows /= 2) {
    if (select_smem(rows, knn, key_bytes, mask) <= MAX_SMEM) return rows;
  }
  return 0;
}

struct Launch {
  const u64 *a, *b;
  long long lda, ldb;
  void* out;
  int tr, ncols, s64;
  KeyParams p;
  cudaStream_t st;
};

template <typename KeyT, bool COMP, bool MASK>
cudaError_t launch_keys(const Launch& l, long long ldo, int tc) {
  cudaError_t err = configured<KeyT, COMP, MASK>();
  if (err != cudaSuccess) return err;
  const dim3 grid((tc + TJ - 1) / TJ, (l.tr + TI - 1) / TI);
  const int smem = RING_BYTES + (MASK ? SIG_STAGE_WORDS * 4 : 0);
  knn_keys_kernel<KeyT, COMP, MASK><<<grid, NT, smem, l.st>>>(
      l.a, l.lda, l.b, l.ldb, static_cast<KeyT*>(l.out), ldo, l.tr, tc,
      l.ncols, l.s64, l.p);
  return cudaGetLastError();
}

template <typename KeyT, bool COMP, bool MASK>
cudaError_t launch_select(const Launch& l, void* part, int knn, int splits) {
  cudaError_t err = configured<KeyT, COMP, MASK>();
  if (err != cudaSuccess) return err;
  const int rows = select_rows(knn, sizeof(KeyT), MASK);
  if (rows == 0) return cudaErrorInvalidValue;
  const int row_tiles = (l.tr + rows - 1) / rows;
  const long long blocks = (long long)row_tiles * splits;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  KeyT* first = static_cast<KeyT*>(splits > 1 ? part : l.out);
  knn_select_kernel<KeyT, COMP, MASK>
      <<<(unsigned)blocks, NT, select_smem(rows, knn, sizeof(KeyT), MASK),
         l.st>>>(l.a, l.lda, l.b, l.ldb, first, l.tr, l.ncols, l.s64, knn,
                 rows, row_tiles, splits, l.p);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  knn_merge_kernel<KeyT>
      <<<(l.tr + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32,
         MERGE_WARPS * knn * sizeof(KeyT), l.st>>>(
          first, static_cast<KeyT*>(l.out), l.tr, knn, splits);
  return cudaGetLastError();
}

// The key type and modes of one instantiation, as a value.
template <typename KeyT, bool COMP, bool MASK>
struct Inst {
  using Key = KeyT;
  static constexpr bool comp = COMP, mask = MASK;
};

// Calls f(Inst<KeyT, COMP, MASK>{}) for the key type and mode of
// (key_bytes, comp, mask).
template <typename F>
int dispatch(int key_bytes, bool comp, bool mask, F f) {
  cudaError_t err = cudaErrorInvalidValue;
  if (key_bytes == 4 && !comp) {
    err = mask ? f(Inst<int, false, true>{}) : f(Inst<int, false, false>{});
  } else if (key_bytes == 8 && !comp) {
    err = mask ? f(Inst<long long, false, true>{})
               : f(Inst<long long, false, false>{});
  } else if (key_bytes == 8) {
    err = mask ? f(Inst<long long, true, true>{})
               : f(Inst<long long, true, false>{});
  }
  return static_cast<int>(err);
}

KeyParams key_params(long long row0, long long col0, int exclude_self,
                     int shift, long long colmask, const void* c1,
                     const void* c2, float cutoff, float expected,
                     float maxnbits, float denom, const void* asig,
                     const void* bsig, int swords, long long sld, int sodd) {
  return KeyParams{row0, col0, exclude_self, shift, colmask,
                   static_cast<const float*>(c1),
                   static_cast<const float*>(c2), cutoff, expected, maxnbits,
                   denom, static_cast<const unsigned*>(asig),
                   static_cast<const unsigned*>(bsig), swords, sld, sodd};
}

}  // namespace

// Tile mode. key_bytes 4: int32 plain keys; 8: int64 keys, completeness
// mode when c1 is not null. c1 (tr) and c2 (tc) are the rows' and columns'
// completeness; out is (tr, tc) with row stride ldo. Masked mode when asig
// is not null: asig (tr rows) and bsig (tc rows) hold `swords` packed sign
// words a row at row stride sld words; sodd: the sign count is odd.
extern "C" int stpu_knn_keys(const void* a, long long lda, const void* b,
                             long long ldb, void* out, long long ldo, int tr,
                             int tc, int ncols, int s64, long long row0,
                             long long col0, int exclude_self, int shift,
                             long long colmask, int key_bytes, const void* c1,
                             const void* c2, float cutoff, float expected,
                             float maxnbits, float denom, const void* asig,
                             const void* bsig, int swords, long long sld,
                             int sodd, void* stream) {
  const Launch l{static_cast<const u64*>(a), static_cast<const u64*>(b),
                 lda, ldb, out, tr, ncols, s64,
                 key_params(row0, col0, exclude_self, shift, colmask, c1, c2,
                            cutoff, expected, maxnbits, denom, asig, bsig,
                            swords, sld, sodd),
                 static_cast<cudaStream_t>(stream)};
  return dispatch(key_bytes, c1 != nullptr, asig != nullptr,
                  [&](auto inst) {
                    using I = decltype(inst);
                    return launch_keys<typename I::Key, I::comp, I::mask>(
                        l, ldo, tc);
                  });
}

// Selection mode: out (tr, knn) gets each row's knn largest keys over the
// columns [0, ncols) of b (global ids from 0), descending, -1 where a row
// has fewer. part: scratch of (splits, tr, knn) keys when splits > 1. The
// sign mask as in tile mode, bsig from column 0.
extern "C" int stpu_knn_select(const void* a, long long lda, const void* b,
                               long long ldb, void* out, void* part, int tr,
                               int ncols, int s64, int knn, int splits,
                               long long row0, int exclude_self, int shift,
                               long long colmask, int key_bytes,
                               const void* c1, const void* c2, float cutoff,
                               float expected, float maxnbits, float denom,
                               const void* asig, const void* bsig, int swords,
                               long long sld, int sodd, void* stream) {
  if (knn < 1 || knn > MAX_KNN || splits < 1 || tr < 1 || ncols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch l{static_cast<const u64*>(a), static_cast<const u64*>(b),
                 lda, ldb, out, tr, ncols, s64,
                 key_params(row0, 0, exclude_self, shift, colmask, c1, c2,
                            cutoff, expected, maxnbits, denom, asig, bsig,
                            swords, sld, sodd),
                 static_cast<cudaStream_t>(stream)};
  return dispatch(key_bytes, c1 != nullptr, asig != nullptr,
                  [&](auto inst) {
                    using I = decltype(inst);
                    return launch_select<typename I::Key, I::comp, I::mask>(
                        l, part, knn, splits);
                  });
}

// Rows per selection block at (knn, key_bytes, mask), 0 when knn does not
// fit.
extern "C" int stpu_knn_select_rows(int knn, int key_bytes, int mask) {
  return knn < 1 || knn > MAX_KNN ? 0 : select_rows(knn, key_bytes, mask);
}

// Resident selection blocks per SM at (knn, key_bytes, comp, mask), or -1.
extern "C" int stpu_knn_select_blocks_per_sm(int knn, int key_bytes,
                                             int comp, int mask) {
  const int rows = stpu_knn_select_rows(knn, key_bytes, mask);
  if (rows == 0) return -1;
  const int bytes = select_smem(rows, knn, key_bytes, mask);
  int n = 0;
  const int rc = dispatch(
      key_bytes, comp != 0, mask != 0,
      [&](auto inst) {
        using I = decltype(inst);
        cudaError_t e = configured<typename I::Key, I::comp, I::mask>();
        return e != cudaSuccess
                   ? e
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n,
                         knn_select_kernel<typename I::Key, I::comp, I::mask>,
                         NT, bytes);
      });
  return rc == 0 ? n : -1;
}
