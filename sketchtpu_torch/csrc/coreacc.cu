// K2: fused multi-k core/accessory distances, the port of
// sketchtpu/dist/coreacc_pallas.py coreacc_pallas (kernel _coreacc_kernel,
// coreacc_pallas.py:100), redesigned for Hopper.
//
// Per pair, for each k in ascending order: samebits -> bias-corrected
// Jaccard j -> optional completeness correction -> y = ln j -> the early
// break (a k counts only while every y so far is >= tolerance) -> running
// regression sums. Then the closed-form least squares gives beta and alpha,
// and core/acc follow the branches of coreacc_jax.coreacc_tile exactly.
// The sums use x = k - kc (kc: the middle k, so x is a small exact
// integer): in f32, sum(k*y) - sum(k)*sum(y)/n cancels two numbers of
// order 1e2 and costs the accessory distance up to ~2e-5 against the f64
// chain; centred, the same slope and intercept stay within ~1e-6. Every
// float operation is the twin's (coreacc_kernels.coreacc_ref), in its
// order, built with --fmad=false, so kernel and twin agree bit for bit.
//
// Two modes. Plain: f32 core and acc (na, nb), with the self-dense
// triangle skip (tri, row0). Keys (the core/accessory kNN scan tile): for
// rows with global ids row0 + i and columns col0 + j, an int64 selection
// key ordered_bits(-core) << 32 | (2^32 - 1 - col) and the f32 acc beside
// it; a column at or past the real column count (j >= ncols) or, with
// exclude_self, equal to the row gets INT64_MIN and acc 0. Keys hold
// their column, so they are unique and a top-k over them orders core
// ascending, then column ascending. Masked key mode (the inverted index's
// precluster, the a_sig / b_sig mask of knn_jax._knn_scan_block_ca_pallas)
// also gives INT64_MIN to a pair whose rows share no u16 sign of the
// index: signeq.cuh's sign_any_mask, run after the (k, chunk) walk through
// the then idle ring's shared memory, so the launch keeps its 112,000
// bytes and its two blocks per SM.
//
// Bound: the integer ALU. A pair and 64-bin chunk costs BBITS LOP3s
// (acc & ~(a ^ b)) on each 32-bit half and two popcounts; Hopper issues
// 64 LOP3 and 16 popcounts per clock and SM. The float chain adds a few
// dozen operations per pair and k, about a tenth of the samebits work at
// s64 = 16.
// Design:
// - 64 x 64 pairs per 256-thread block, 4 x 4 pairs per thread (K1's
//   tile): each staged plane word feeds four pairs.
// - The (k, chunk) sequence is flattened and staged G = 2 chunks per stage
//   into a two-stage ring with 8-byte cp.async (zero-filled past the last
//   row), transposed to [plane][row] so a warp reads neighbouring words;
//   the next stage's copies fly while this one is consumed, across k
//   boundaries and for any s64, with one barrier per stage.
// - The chain's running state (y, k*y, y*y sums and the included-k count)
//   lives in shared memory, one slot per pair and thread, updated once per
//   k: only the 16 samebits counts and the AND chains stay in registers.
// - The centred k values and their prefix sums (sum x and sum x^2 over
//   the first n included k, which the early break makes a prefix) come by
//   value in a __grid_constant__ table (3 KB of the 4 KB parameter space)
//   for up to MAX_NK_BY_VALUE = 255 k values, with the included-k count a
//   byte. Past that (up to MAX_NK = 65535 k) the WIDE instantiations read
//   the same table from device memory, copied there by the wrapper at each
//   launch (the words slots launch on several streams at once, so no
//   __constant__ table can be shared between launches), and keep the count
//   in 16 bits: 4096 more bytes of shared memory a block, which leave one
//   block an SM. The bits are the same: the table holds the same floats,
//   and the chain runs the same operations in the same order.
// - One-dimensional grid with row tiles fastest, so the blocks resident
//   together share their column tiles in L2.
// ptxas (-Xptxas -v, sm_90a, nvcc 12.9): 128 registers, no spills, in both
// modes; with 112,000 bytes of dynamic shared memory each, 2 blocks of 256
// threads are resident per SM (WIDE: 116,096 bytes, 1 block). chip_smoke.py
// prints all six instantiations'.
//
// coreacc_chain: the same chain from the words slots' int32 (nk, na, nb)
// slabs of partial samebits counts, the port of the regression chain of
// sketchtpu/dist/coreacc_jax.py coreacc_tile after its psum over the mesh's
// words axis (an XLA program; coreacc_jax.py:73-82 applies completeness
// after the sum). A words split computes each slot's partial samebits with
// K4 (one multi-plane launch a slot); this kernel takes the w slabs as they
// stand (a by-value array of at most MAX_WORDS_SLOTS pointers), sums each pair's
// count at each k in registers, and runs K2's chain on the sums, through
// the same device functions (chain_y, chain_add, chain_finish) and the same
// k table (by value, or WIDE in device memory), so a split core/acc is
// K2's bit for bit; no summed slab is
// written. One thread a pair, its chain state in registers. Bound: bytes
// (w * nk * 4 read and 8 written a pair); its f32 chain (two IEEE
// divisions and a logf a pair and k, without FMA) keeps it from that
// bound.
#include <math.h>
#include <string.h>

#include "signeq.cuh"
#include "tile.cuh"

using namespace stpu;

namespace {

constexpr int TX = 16, TY = 16;  // threads
constexpr int RM = 4, RN = 4;    // pairs per thread
constexpr int TI = TY * RM, TJ = TX * RN, NT = TX * TY;
constexpr int NSLOT = RM * RN;
constexpr int LDS = RING_LDS;  // words per staged plane
constexpr int G = RING_G;      // chunks per stage
constexpr int STAGES = RING_STAGES;
// k values of a launch whose table comes by value (s_n, the included-k
// count, a byte), and of any launch (past MAX_NK_BY_VALUE: WIDE, s_n 16
// bits)
constexpr int MAX_NK_BY_VALUE = 255;
constexpr int MAX_NK = 65535;
constexpr int OPERAND_STAGE = G * RING_CHUNK;  // words of one operand's stage
static_assert(TI == RING_ROWS && TJ == RING_ROWS,
              "the ring stages 64 rows of each operand");
static_assert(SIG_STAGE_WORDS * 4 <= STAGES * OPERAND_STAGE * 8,
              "the sign mask stages through the first operand's ring");

// The masked key mode's signs: rows' (tile-local row index) and columns'
// (tile-local column index) packed words, words a row, row stride, odd
// sign count.
struct SignArgs {
  const unsigned* asig;
  const unsigned* bsig;
  int words;
  long long ld;
  int odd;
};

// The k table, passed by value: kf[q] = k_q - kc; xs[n] and xq[n] are the
// f32 sums, in order, of kf[q] and kf[q] * kf[q] over q < n.
struct KTable {
  float kf[MAX_NK_BY_VALUE];
  float xs[MAX_NK_BY_VALUE + 1];
  float xq[MAX_NK_BY_VALUE + 1];
  float kc;
};
static_assert(sizeof(KTable) == (3 * MAX_NK_BY_VALUE + 3) * sizeof(float),
              "KTable is a flat float array on the host side");

// Past MAX_NK_BY_VALUE k, the same table of nk values in device memory:
// kf, xs and xq point at nk, nk + 1 and nk + 1 floats.
struct KTableDev {
  const float* kf;
  const float* xs;
  const float* xq;
  float kc;
};

// The table and the included-k count's type of a launch: by value and a
// byte, or (WIDE) in device memory and 16 bits.
template <bool WIDE>
struct KWidth {
  typedef KTable Table;
  typedef unsigned char Count;
};
template <>
struct KWidth<true> {
  typedef KTableDev Table;
  typedef unsigned short Count;
};

// K2's dynamic shared memory: the staged words, the chain state (three
// floats and the included-k count a pair and thread) and the completeness
// values.
template <bool WIDE>
constexpr int smem_bytes() {
  return 2 * STAGES * OPERAND_STAGE * 8
         + NSLOT * NT * (3 * 4 + (int)sizeof(typename KWidth<WIDE>::Count))
         + (TI + TJ) * 4;
}

// The chain's constants: the whole sketch's Jaccard bias correction, the
// early break's tolerance and the completeness cutoff.
struct Chain {
  float expected, maxnbits, denom, tolerance, cutoff;
};

// One k of the chain for one pair: the samebits count cnt to y = ln of the
// bias-corrected Jaccard, completeness-corrected where comp and
// c1 * c2 >= cutoff (c1p / c2p: the row's and the column's values).
__device__ __forceinline__ float chain_y(int cnt, const Chain& ch, bool comp,
                                        const float* c1p, const float* c2p) {
  const float diff = fmaxf((float)cnt - ch.expected, 0.f);
  float jac = (diff * ch.maxnbits / ch.denom) / ch.maxnbits;
  if (comp) {
    const float c1v = *c1p, c2v = *c2p;
    const float prod = c1v * c2v;
    const float factor = prod / (c1v + c2v - prod);
    if (prod >= ch.cutoff) {
      const float q = jac / factor;
      jac = q > 1.f ? 1.f : q;  // NaN-propagating min, as jnp.minimum
    }
  }
  return logf(jac);
}

// The early break and the running sums: k-plane ki (centred value kv)
// counts only while every y so far is >= tolerance, i.e. while the
// included-k count n is still ki.
template <typename N>
__device__ __forceinline__ void chain_add(N& n, float& ys, float& xy,
                                          float& yy, int ki, float kv, float y,
                                          float tolerance) {
  if (n == ki && y >= tolerance) {
    n = ki + 1;
    ys += y;
    xy += kv * y;
    yy += y * y;
  }
}

// The closed-form fit of the ninc included k and its branches:
// coreacc_jax.coreacc_tile's core and acc (KT: KTable or KTableDev).
template <typename KT>
__device__ __forceinline__ void chain_finish(int ninc, float ysum,
                                             float xysum, float yysum,
                                             const KT& kt, float& cd,
                                             float& ad) {
  const float xsum = kt.xs[ninc], xsq = kt.xq[ninc];
  const float n = (float)ninc;
  const float xbar = xsum / n + kt.kc;
  const float ybar = ysum / n;
  const float x_diff = xsq - xsum * xsum / n;
  const float y_diff = yysum - ysum * ysum / n;
  const float beta = (xysum - xsum * ysum / n) / x_diff;
  const float alpha = -beta * xbar + ybar;
  cd = beta < 0.f ? 1.f - expf(beta) : (beta > 0.f ? 1.f : 0.f);
  ad = alpha < 0.f ? 1.f - expf(alpha) : 0.f;
  if (y_diff <= 0.f) cd = ad = 0.f;
  if (isnan(ysum) || (isinf(ysum) && ysum < 0.f) || n < 3.f) cd = ad = 1.f;
}

__device__ __forceinline__ int ordered_bits(float v) {
  const int b = __float_as_int(v);
  return b < 0 ? b ^ 0x7FFFFFFF : b;
}

template <bool KEYS, bool MASK, bool WIDE>
__global__ void __launch_bounds__(NT, 2)
    coreacc_kernel(const u64* __restrict__ a, long long lda,
                   const u64* __restrict__ b, long long ldb,
                   long long kstride, int na, int nb, int ncols, int s64,
                   int nk,
                   const __grid_constant__ typename KWidth<WIDE>::Table kt,
                   const float* __restrict__ c1,
                   const float* __restrict__ c2, float cutoff,
                   float expected, float maxnbits, float denom,
                   float tolerance, float* __restrict__ core,
                   long long* __restrict__ keys, float* __restrict__ acc,
                   long long ldo, int tiles_i, int tri, long long row0,
                   long long col0, int exclude_self, const SignArgs sg) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sA = reinterpret_cast<u64*>(smem);
  u64* sB = sA + STAGES * OPERAND_STAGE;
  float* s_y = reinterpret_cast<float*>(sB + STAGES * OPERAND_STAGE);
  float* s_xy = s_y + NSLOT * NT;
  float* s_yy = s_xy + NSLOT * NT;
  float* s_c1 = s_yy + NSLOT * NT;
  float* s_c2 = s_c1 + TI;
  typedef typename KWidth<WIDE>::Count Count;
  Count* s_n = reinterpret_cast<Count*>(s_c2 + TJ);

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int i0 = (blockIdx.x % tiles_i) * TI;
  const int j0 = (blockIdx.x / tiles_i) * TJ;

  if (!KEYS && tri && tile_below_diagonal(i0, j0, TJ, nb, row0)) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gi = i0 + ty + i * TY;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gj = j0 + tx + j * TX;
        if (gi < na && gj < nb) {
          core[(long long)gi * ldo + gj] = 0.f;
          acc[(long long)gi * ldo + gj] = 0.f;
        }
      }
    }
    return;
  }
  if (KEYS && j0 >= ncols) {  // wholly past the real columns
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gi = i0 + ty + i * TY;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gj = j0 + tx + j * TX;
        if (gi < na && gj < nb) {
          keys[(long long)gi * ldo + gj] = (long long)(1ull << 63);
          acc[(long long)gi * ldo + gj] = 0.f;
        }
      }
    }
    return;
  }

  const bool comp = c1 != nullptr;
  const Chain ch{expected, maxnbits, denom, tolerance, cutoff};
  for (int e = tid; e < TI; e += NT)
    s_c1[e] = comp && i0 + e < na ? c1[i0 + e] : 1.f;
  for (int e = tid; e < TJ; e += NT)
    s_c2[e] = comp && j0 + e < ncols ? c2[j0 + e] : 1.f;
#pragma unroll
  for (int q = 0; q < NSLOT; ++q) {
    s_y[q * NT + tid] = 0.f;
    s_xy[q * NT + tid] = 0.f;
    s_yy[q * NT + tid] = 0.f;
    s_n[q * NT + tid] = 0;
  }

  // Staging role (tile.cuh): warps 0-3 copy A rows, 4-7 B rows.
  const RingRole role = ring_role(tid);
  const bool is_b = role.second;
  const u64* sop = is_b ? b : a;
  const long long sld = is_b ? ldb : lda;
  const int svalid = (is_b ? ncols - j0 : na - i0) - role.row;  // rows left
  const u64* ssrc =
      sop + (long long)((is_b ? j0 : i0) + role.row) * sld + role.plane;

  const int total = nk * s64;  // flattened (k, chunk) sequence
  const int nstage = (total + G - 1) / G;
  auto load_stage = [&](int s) {
    if (!role.stager) return;
    const int buf = s % STAGES;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int t = s * G + g;
      if (t >= total) break;
      const int ki = t / s64;
      const long long off = ki * kstride + (long long)(t - ki * s64) * BBITS;
      ring_copy(ring_slot(is_b ? sB : sA, role, buf, g), ssrc + off, sld,
                svalid, sop);
    }
  };

  load_stage(0);
  cp_async_commit();
  int cnt[RM][RN] = {};
  int ki = 0, c = 0;  // k-plane and chunk of the next chunk consumed
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s is in; everyone is done with stage s - 1
    if (s + 1 < nstage) load_stage(s + 1);
    cp_async_commit();
    const int buf = s % STAGES;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (s * G + g >= total) break;
      const int at = (buf * G + g) * BBITS * LDS;
      samebits_chunk<RM, RN, TY, TX, LDS, LDS>(
          cnt, reinterpret_cast<const u64(*)[LDS]>(sA + at),
          reinterpret_cast<const u64(*)[LDS]>(sB + at), ty, tx);
      if (++c < s64) continue;
      // k-plane ki is complete: one step of the chain for each pair
      const float kv = kt.kf[ki];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const float y = chain_y(cnt[i][j], ch, comp, s_c1 + ty + i * TY,
                                  s_c2 + tx + j * TX);
          const int slot = (i * RN + j) * NT + tid;
          chain_add(s_n[slot], s_y[slot], s_xy[slot], s_yy[slot], ki, kv, y,
                    ch.tolerance);
          cnt[i][j] = 0;
        }
      }
      c = 0;
      ++ki;
    }
  }

  unsigned mbits = ~0u;
  if (MASK) {  // the walk is over: its ring holds no stage in flight
    const SignOperand sa{sg.asig + (long long)i0 * sg.ld, sg.ld, na - i0};
    const SignOperand sb{sg.bsig + (long long)j0 * sg.ld, sg.ld, ncols - j0};
    mbits = sign_any_mask<RM, RN, TY, TX>(
        sa, sb, sg.words, sg.odd, reinterpret_cast<unsigned*>(sA), ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gi = i0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gj = j0 + tx + j * TX;
      if (gi >= na || gj >= nb) continue;
      const int slot = (i * RN + j) * NT + tid;
      float cd, ad;
      chain_finish(s_n[slot], s_y[slot], s_xy[slot], s_yy[slot], kt, cd, ad);
      const long long o = (long long)gi * ldo + gj;
      if (KEYS) {
        const long long col = col0 + gj;
        if (gj >= ncols || (exclude_self && col == row0 + gi) ||
            !((mbits >> (i * RN + j)) & 1u)) {
          keys[o] = (long long)(1ull << 63);
          if (gj >= ncols) ad = 0.f;
        } else {
          const unsigned long long hi =
              (unsigned long long)(long long)ordered_bits(-cd) << 32;
          keys[o] = (long long)(hi | (0xFFFFFFFFull - (unsigned long long)col));
        }
      } else {
        core[o] = cd;
      }
      acc[o] = ad;
    }
  }
}

// coreacc_chain: one thread a pair of the (na, nb) plane, the chain over
// the nk planes (plane stride na * nb) of the summed slabs in registers.
constexpr int CHAIN_NT = 256;

template <bool WIDE>
__global__ void __launch_bounds__(CHAIN_NT)
    coreacc_chain_kernel(const WordsParts sb, int na, int nb, int nk,
                         const __grid_constant__
                         typename KWidth<WIDE>::Table kt,
                         const float* __restrict__ c1,
                         const float* __restrict__ c2, const Chain ch,
                         float* __restrict__ core, float* __restrict__ acc) {
  const long long plane = (long long)na * nb;
  const long long p = (long long)blockIdx.x * CHAIN_NT + threadIdx.x;
  if (p >= plane) return;
  const bool comp = c1 != nullptr;
  const float* c1p = comp ? c1 + p / nb : nullptr;
  const float* c2p = comp ? c2 + p % nb : nullptr;
  int ninc = 0;
  float ys = 0.f, xy = 0.f, yy = 0.f;
  for (int ki = 0; ki < nk; ++ki) {
    const long long at = ki * plane + p;
    int cnt = 0;
#pragma unroll
    for (int s = 0; s < MAX_WORDS_SLOTS; ++s) {
      if (s < sb.n) cnt += __ldg(sb.p[s] + at);
    }
    const float y = chain_y(cnt, ch, comp, c1p, c2p);
    chain_add(ninc, ys, xy, yy, ki, kt.kf[ki], y, ch.tolerance);
  }
  float cd, ad;
  chain_finish(ninc, ys, xy, yy, kt, cd, ad);
  core[p] = cd;
  acc[p] = ad;
}

// at every launch and query: the attributes belong to the current device
// only, and the caller makes the tensors' device current
template <bool KEYS, bool MASK, bool WIDE>
cudaError_t configured() {
  cudaError_t err = cudaFuncSetAttribute(
      coreacc_kernel<KEYS, MASK, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<WIDE>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(coreacc_kernel<KEYS, MASK, WIDE>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The arguments of a K2 launch but its k table (out: core f32, or keys
// int64 in key mode).
struct K2Args {
  const u64* a;
  long long lda;
  const u64* b;
  long long ldb, kstride;
  int na, nb, ncols, s64, nk;
  const float* c1;
  const float* c2;
  float cutoff, expected, maxnbits, denom, tolerance;
  void* out;
  float* acc;
  long long ldo;
  int tiles_i, tri;
  long long row0, col0;
  int exclude_self;
  SignArgs sg;
};

template <bool KEYS, bool MASK, bool WIDE>
cudaError_t launch_k2(const K2Args& g,
                      const typename KWidth<WIDE>::Table& kt,
                      unsigned tiles, cudaStream_t st) {
  const cudaError_t err = configured<KEYS, MASK, WIDE>();
  if (err != cudaSuccess) return err;
  constexpr int smem = smem_bytes<WIDE>();
  coreacc_kernel<KEYS, MASK, WIDE><<<tiles, NT, smem, st>>>(
      g.a, g.lda, g.b, g.ldb, g.kstride, g.na, g.nb, g.ncols, g.s64, g.nk,
      kt, g.c1, g.c2, g.cutoff, g.expected, g.maxnbits, g.denom, g.tolerance,
      KEYS ? nullptr : static_cast<float*>(g.out),
      KEYS ? static_cast<long long*>(g.out) : nullptr, g.acc, g.ldo,
      g.tiles_i, KEYS ? 0 : g.tri, g.row0, g.col0, g.exclude_self, g.sg);
  return cudaGetLastError();
}

// key mode 0 plain, 1 keys, 2 masked keys
template <bool WIDE>
cudaError_t launch_mode(int mode, const K2Args& g,
                        const typename KWidth<WIDE>::Table& kt,
                        unsigned tiles, cudaStream_t st) {
  if (mode == 2) return launch_k2<true, true, WIDE>(g, kt, tiles, st);
  if (mode == 1) return launch_k2<true, false, WIDE>(g, kt, tiles, st);
  return launch_k2<false, false, WIDE>(g, kt, tiles, st);
}

template <bool KEYS, bool MASK, bool WIDE>
int blocks_per_sm() {
  int n = 0;
  cudaError_t err = configured<KEYS, MASK, WIDE>();
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, coreacc_kernel<KEYS, MASK, WIDE>, NT, smem_bytes<WIDE>());
  }
  return err == cudaSuccess ? n : -1;
}

// The table of nk k values as the kernels take it: by value (up to
// MAX_NK_BY_VALUE k; ktable holds 3 * MAX_NK_BY_VALUE + 3 floats) or in
// device memory (ktable_dev: kf, xs, xq of nk, nk + 1, nk + 1 floats, then
// kc; ktable the same on the host).
KTable table_by_value(const float* ktable) {
  KTable kt;
  memcpy(&kt, ktable, sizeof kt);
  return kt;
}

KTableDev table_on_device(const float* ktable, const void* ktable_dev,
                          int nk) {
  const float* base = static_cast<const float*>(ktable_dev);
  return KTableDev{base, base + nk, base + 2 * nk + 1, ktable[3 * nk + 2]};
}

}  // namespace

// keys 0: plain mode, out = core (f32); keys 1: key mode, out = int64
// keys, masked when asig is not null (asig: na rows, bsig: nb rows of
// swords packed sign words at row stride sld; sodd: odd sign count).
// ktable: the k table (host memory) as 3 * w + 3 floats, w = nk past
// MAX_NK_BY_VALUE k and MAX_NK_BY_VALUE else; ktable_dev: past
// MAX_NK_BY_VALUE k, the same floats in device memory (else ignored).
// ncols: the real columns (plain mode: nb). Rows are a (na) and b (nb)
// with row strides lda / ldb words and k-plane stride kstride words.
extern "C" int stpu_coreacc(const void* a, long long lda, const void* b,
                            long long ldb, long long kstride, int na, int nb,
                            int ncols, int s64, int nk, const float* ktable,
                            const void* ktable_dev, const void* c1,
                            const void* c2, float cutoff, float expected,
                            float maxnbits, float denom, float tolerance,
                            void* out, void* acc, long long ldo, int keys,
                            int tri, long long row0, long long col0,
                            int exclude_self, const void* asig,
                            const void* bsig, int swords, long long sld,
                            int sodd, void* stream) {
  const bool wide = nk > MAX_NK_BY_VALUE;
  if (nk < 1 || nk > MAX_NK || s64 < 1 ||
      (long long)nk * s64 > 0x7FFFFFFFLL || (wide && ktable_dev == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_i = (na + TI - 1) / TI;
  const long long tiles = (long long)tiles_i * ((nb + TJ - 1) / TJ);
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const K2Args g{static_cast<const u64*>(a),
                 lda,
                 static_cast<const u64*>(b),
                 ldb,
                 kstride,
                 na,
                 nb,
                 ncols,
                 s64,
                 nk,
                 static_cast<const float*>(c1),
                 static_cast<const float*>(c2),
                 cutoff,
                 expected,
                 maxnbits,
                 denom,
                 tolerance,
                 out,
                 static_cast<float*>(acc),
                 ldo,
                 tiles_i,
                 tri,
                 row0,
                 col0,
                 exclude_self,
                 SignArgs{static_cast<const unsigned*>(asig),
                          static_cast<const unsigned*>(bsig), swords, sld,
                          sodd}};
  const int mode = keys ? (asig != nullptr ? 2 : 1) : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      wide ? launch_mode<true>(mode, g,
                               table_on_device(ktable, ktable_dev, nk),
                               (unsigned)tiles, st)
           : launch_mode<false>(mode, g, table_by_value(ktable),
                                (unsigned)tiles, st);
  return static_cast<int>(err);
}

// Resident blocks per SM of the kernel at its launch configuration, or -1:
// keys 0 plain mode, 1 key mode, 2 masked key mode; wide 1: the
// instantiation past MAX_NK_BY_VALUE k.
extern "C" int stpu_coreacc_blocks_per_sm(int keys, int wide) {
  if (wide) {
    if (keys == 2) return blocks_per_sm<true, true, true>();
    if (keys == 1) return blocks_per_sm<true, false, true>();
    return blocks_per_sm<false, false, true>();
  }
  if (keys == 2) return blocks_per_sm<true, true, false>();
  if (keys == 1) return blocks_per_sm<true, false, false>();
  return blocks_per_sm<false, false, false>();
}

// coreacc_chain: core and acc (na, nb) f32 from the sum of nslabs int32
// (nk, na, nb) slabs of partial samebits counts (slabs: a host array of
// device pointers); c1 (na) / c2 (nb) f32 completeness or null; ktable and
// ktable_dev as for stpu_coreacc; the constants are the whole sketch's.
extern "C" int stpu_coreacc_chain(const void* const* slabs, int nslabs,
                                  int na, int nb, int nk,
                                  const float* ktable, const void* ktable_dev,
                                  const void* c1, const void* c2,
                                  float cutoff, float expected,
                                  float maxnbits, float denom,
                                  float tolerance, void* core, void* acc,
                                  void* stream) {
  const bool wide = nk > MAX_NK_BY_VALUE;
  if (nk < 1 || nk > MAX_NK || nslabs < 1 || nslabs > MAX_WORDS_SLOTS ||
      (wide && ktable_dev == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WordsParts sb{};
  for (int s = 0; s < nslabs; ++s) sb.p[s] = static_cast<const int*>(slabs[s]);
  sb.n = nslabs;
  const long long blocks = ((long long)na * nb + CHAIN_NT - 1) / CHAIN_NT;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const Chain ch{expected, maxnbits, denom, tolerance, cutoff};
  const float* pc1 = static_cast<const float*>(c1);
  const float* pc2 = static_cast<const float*>(c2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    coreacc_chain_kernel<true><<<(unsigned)blocks, CHAIN_NT, 0, st>>>(
        sb, na, nb, nk, table_on_device(ktable, ktable_dev, nk), pc1, pc2,
        ch, static_cast<float*>(core), static_cast<float*>(acc));
  } else {
    coreacc_chain_kernel<false><<<(unsigned)blocks, CHAIN_NT, 0, st>>>(
        sb, na, nb, nk, table_by_value(ktable), pc1, pc2, ch,
        static_cast<float*>(core), static_cast<float*>(acc));
  }
  return static_cast<int>(cudaGetLastError());
}
